"""Ingest — the batcher, the importer and the IDK-style pipeline.

- ``Batch`` (batch/batch.go:55 RecordBatch): records gathered on the
  client, keys translated a batch at a time, one import a field a
  flush.
- ``Importer`` (importer.go:13): the bridge to the engine;
  ``APIImporter`` is the in-process one, whose ``sync`` is the
  durability barrier.
- ``Pipeline`` (idk/ingest.go:59 Main): Source → schema → batches →
  imports, with per-worker clones and offset commits.
- Sources (idk/csv, idk/datagen, idk/kafka): CSV files with typed
  headers, a seeded generator, and a Kafka gate; ``kafka.py`` and
  ``avro.py`` hold the in-process broker's consumer-group sources.
- ``StreamWriter`` / ``StreamImporter`` (``stream.py``): the
  crash-consistent streaming write plane — coalesced windows, acks
  after the durable land, bounded backlogs.
"""

from pilosa_tpu_torch.ingest.batch import Batch, Record
from pilosa_tpu_torch.ingest.importer import APIImporter, HTTPImporter, Importer
from pilosa_tpu_torch.ingest.pipeline import Pipeline
from pilosa_tpu_torch.ingest.sources import (
    CSVSource,
    DatagenSource,
    KafkaSource,
    Source,
)
from pilosa_tpu_torch.ingest.stream import (
    MutationError,
    StreamImporter,
    StreamWriter,
    WriteBacklogError,
)

__all__ = ["Batch", "Record", "Importer", "APIImporter", "HTTPImporter",
           "Pipeline", "Source", "CSVSource", "DatagenSource", "KafkaSource",
           "StreamWriter", "StreamImporter", "WriteBacklogError",
           "MutationError"]
