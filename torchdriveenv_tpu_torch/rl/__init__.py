"""RL training stack (port of ``torchdriveenv_tpu/rl``): the frame-stacked
rollout, the on-device replay buffer, the SAC learner, the scripted
demonstration driver and the evaluator."""
