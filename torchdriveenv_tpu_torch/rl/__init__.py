"""RL training stack (port of ``torchdriveenv_tpu/rl``): the frame-stacked
rollout, the on-device replay buffer, the SAC, TD3, PPO and A2C learners,
the scripted demonstration driver, the evaluator and the training CLI
(``train.py``)."""
