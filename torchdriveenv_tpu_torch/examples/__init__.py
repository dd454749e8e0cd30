"""Examples (ports of the repository's ``examples/``): policy evaluation, a
rollout with video, and ``train_gpu.sh``, the launcher of the training CLI.
Run the Python ones as ``python -m torchdriveenv_tpu_torch.examples.<name>``."""
