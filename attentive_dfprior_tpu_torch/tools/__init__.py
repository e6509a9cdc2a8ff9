"""Evaluation tools of the port (numpy and the native host library)."""
