"""Inference: batch enhancement (``batch.py``) and its CLI (``__main__.py``),
frame-by-frame streaming (``streaming.py``), the concurrent-stream server
(``server.py``) and its CLI (``serve.py``), and self-contained
``torch.export`` artifacts (``artifact.py``) with their export and run CLIs
(``export.py``, ``run_exported.py``)."""
