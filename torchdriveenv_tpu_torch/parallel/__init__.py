"""Fused training steps (port of ``torchdriveenv_tpu/parallel``): env
stepping, replay insertion and learner updates in one call on one device."""
