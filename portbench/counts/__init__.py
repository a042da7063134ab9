"""Operation and byte counts, one module per configuration family."""
