"""Host-side data utilities of the port: tokenization and packing."""
