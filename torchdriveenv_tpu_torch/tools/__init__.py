"""The user workflow around training (ports of the JAX package's ``tools/``
scripts), each run as ``python -m torchdriveenv_tpu_torch.tools.<name>``:
the BC warm start, NPC distillation, the checkpoint sweep, the learner and
env-step profilers, the validation diagnostics and the map audit. Every
entry point runs on the GPU unless ``--device cpu`` asks for the CPU."""
