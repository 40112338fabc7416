"""Data IO of the port: wav read/write and manifests."""
