"""Generated protobuf messages for the gRPC plane.

pilosa_tpu_pb2.py is generated from pilosa_tpu.proto by protoc
(``protoc --python_out=. pilosa_tpu.proto``) and checked in, the way
the reference checks in its generated pb/ code.  The wire messages are
the JAX package's, byte for byte, so a client of either server talks to
both.  Importing this module needs ``google.protobuf``.
"""

from pilosa_tpu_torch.server.proto import pilosa_tpu_pb2 as pb  # noqa: F401
