"""Synchronous serving engine of the port: shape buckets, micro-batches,
one dispatch per batch through kernels.ops."""
