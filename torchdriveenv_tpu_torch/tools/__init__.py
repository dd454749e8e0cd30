"""The user workflow around training (ports of the JAX package's ``tools/``
scripts), each run as ``python -m torchdriveenv_tpu_torch.tools.<name>``:
the BC warm start, NPC distillation, the checkpoint sweep, the validation
diagnostics and the map audit. Every entry point runs on the GPU unless
``--device cpu`` asks for the CPU. The port's speed is measured by the
benchmark (``python3 -m benchmark.run``); its phases' times by the spans
of ``utils/spans.py`` (``with spans.recording():``)."""
