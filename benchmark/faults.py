"""Faults planted under the timed path, for the tests and the control's
readings (``python3 -m benchmark.control --fault <name>``): with any of
them a run's ``correct`` has to come out false. The benchmark's own runs
never plant one. (A one-card cell has no exchange between cards to leave
out.)

An env fault wraps the env step (``step_fn(state, actions, generator)``);
a training fault wraps the agent's ``update`` (and returns the train step
it was given)."""

from __future__ import annotations

import torch


def _unchanged(step_fn):
    """The step returns the state it was given."""
    def step(state, actions, g):
        return step_fn(state, actions, g)._replace(state=state)
    return step


def _half_left_out(step_fn):
    """The second half of the batch keeps its old state."""
    def step(state, actions, g):
        out = step_fn(state, actions, g)
        b = state.town.shape[0]
        rest = torch.arange(b, device=state.town.device) >= b // 2
        return out._replace(state=out.state.select(rest, state))
    return step


def _reward_altered(step_fn):
    """One env's reward is off by 0.5 where the step produces it."""
    def step(state, actions, g):
        out = step_fn(state, actions, g)
        reward = out.reward.clone()
        reward[0] += 0.5
        return out._replace(reward=reward)
    return step


def _frame_altered(step_fn):
    """One env's frame is inverted where the step produces it."""
    def step(state, actions, g):
        out = step_fn(state, actions, g)
        obs = out.obs.clone()
        obs[0] = 255 - obs[0]
        return out._replace(obs=obs)
    return step


def _state_drift(step_fn):
    """Every agent's x position creeps 2 mm further each step, where the
    step produces its state: a gap that grows over the steps the reference
    replays on its own."""
    def step(state, actions, g):
        out = step_fn(state, actions, g)
        xs = out.state.agent_states.clone()
        xs[..., 0] += 2e-3
        return out._replace(state=out.state.replace(agent_states=xs))
    return step


ENV_FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out,
              "reward_altered": _reward_altered,
              "frame_altered": _frame_altered, "state_drift": _state_drift}


def _wrap_update(change):
    def fault(train_step, agent):
        update = agent.update

        def faulty(batch, *args, **kwargs):
            return change(update, agent, batch, *args, **kwargs)
        agent.update = faulty
        return train_step
    return fault


def _update_unchanged(update, agent, batch, *args, **kwargs):
    """The update leaves the critic as it found it."""
    params = list(agent.state.critic.parameters())
    kept = [p.detach().clone() for p in params]
    out = update(batch, *args, **kwargs)
    with torch.no_grad():
        for p, k in zip(params, kept):
            p.copy_(k)
    return out


def _update_half_batch(update, agent, batch, *args, **kwargs):
    """Half of the batch left out: the means are over the other half."""
    half = batch["reward"].shape[0] // 2
    rows = {k: v[:half] for k, v in batch.items()}
    return update(rows, *args, **kwargs)


def _update_reward_altered(update, agent, batch, *args, **kwargs):
    """Every sampled reward off by 1.0 where the update reads it."""
    return update(dict(batch, reward=batch["reward"] + 1.0), *args, **kwargs)


TRAIN_FAULTS = {"unchanged": _wrap_update(_update_unchanged),
                "half_batch": _wrap_update(_update_half_batch),
                "reward_altered": _wrap_update(_update_reward_altered)}
