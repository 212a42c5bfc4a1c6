"""Launchers (PyTorch port): the LM training driver (``launch/train.py``),
the serving driver (``launch/serve.py``), the
experiment sweep (``launch/sweep.py``), population training
(``launch/pop.py``), the instrumented rollout (``launch/profile.py``), the
run-history trends (``launch/history.py``) and the one-card dry run
(``launch/dryrun.py``, over ``launch/specs.py`` and ``launch/analysis.py``);
each runs as ``python -m repro_torch.launch.<name>``, and all of them
through the dispatcher ``python -m repro_torch.launch <name>``
(``launch/__main__.py``)."""
