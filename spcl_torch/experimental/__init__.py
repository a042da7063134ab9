"""Opt-in paths of the port that are off the default configuration."""
