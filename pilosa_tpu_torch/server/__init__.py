"""Server — the HTTP transport over the API facade (``http.py``), its
authentication and authorization (``authn.py``, ``authz.py``), and the
gRPC plane (``grpc.py``, which needs grpcio and protobuf and is imported
only when a node asks for it)."""

from pilosa_tpu_torch.server.http import HTTPServer, Server

__all__ = ["HTTPServer", "Server"]
