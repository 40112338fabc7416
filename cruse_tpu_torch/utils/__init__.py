"""Utilities of the port: the weight bridge from cruse_tpu flax variables,
config files and log lines."""
