"""The training run's rate over the traced run's untraced window: the env
transitions of its whole train steps over its time, from its start to the
``synchronize`` after its last train step. The host launches every
operation of a train step and sets this rate, and a host that is shared
moves it by a fifth from run to run, so it stands here, beside the
device's time a train step, without a bound."""

MOVES = "train_step_device_ms"


def read(r):
    return r.get("train_env_steps_per_s")
