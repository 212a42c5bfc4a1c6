"""Launchers (PyTorch port): the serving driver (``launch/serve.py``), the
experiment sweep (``launch/sweep.py``) and the run-history trends
(``launch/history.py``); each runs as ``python -m repro_torch.launch.<name>``."""
