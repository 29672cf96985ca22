"""Data-parallel execution: record batches sharded over a device mesh
(``mesh``) and the host helpers of multi-process runs (``distributed``)."""
