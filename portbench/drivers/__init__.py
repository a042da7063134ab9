"""The cells' drivers: one module per kind of trainer a configuration names."""
