"""The mean time of one learner update in the traced run's window: CUDA
events recorded around each call of the agent's ``update`` (the harness
wraps it; the update's own code is unchanged), over every update of the
window (their count is ``updates_timed`` in the line)."""

MOVES = "train_step_device_ms"


def read(r):
    return r.get("learner_update_ms")
