"""Data of the port: wav read/write, manifests, the on-card mixer, the
synthetic-mixing dataset, its prefetcher and the native I/O bindings."""
