"""Launchers (PyTorch port): the serving driver (``launch/serve.py``)."""
