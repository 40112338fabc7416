"""Inference: batch enhancement (``batch.py``) and its CLI (``__main__.py``)."""
