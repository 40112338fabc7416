"""Inference: batch enhancement (``batch.py``) and its CLI (``__main__.py``),
frame-by-frame streaming (``streaming.py``), and the concurrent-stream server
(``server.py``) and its CLI (``serve.py``)."""
