"""PyTorch/CUDA port of the GRLE system (the JAX package ``repro`` is the
reference it is held against).

``repro_torch/<sub>/<mod>.py`` mirrors ``repro/<sub>/<mod>.py``. The port
imports ``torch`` and never JAX or anything of ``repro``. Entry points
(``MECEnv``, ``AgentDef``/``agent_def``, ``RolloutDriver``) take
``device=None``, which means ``"cuda"``: they raise when no GPU is present
unless the caller asks for ``device="cpu"``. The tensor's device picks the
kernel backend — CUDA tensors reach the hand-written kernels in
``csrc/``, CPU tensors their plain PyTorch versions in ``kernels/ref.py``.
"""
