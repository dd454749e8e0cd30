"""Carry parameters between the JAX package's layout and this package's.

The JAX side is given and returned as nested dicts of numpy arrays, the way
a checkpoint of the JAX package restores (``{"params": {"torso": {"conv1":
{"kernel", "bias"}, ...}, "latent": ..., ...}}``); nothing here imports JAX.
This side is a flat ``state_dict`` (``"torso.conv1.weight"``, ...).

What differs between the two layouts:
  - convolution kernels are HWIO there and OIHW here;
  - dense kernels are (in, out) there and (out, in) here;
  - the torso's ``fc`` flattens an NHWC map there, rows ordered (h, w, c),
    and an NCHW map here, columns ordered (c, h, w): its rows are permuted,
    which needs the map's side and so ``obs_res``;
  - an optax Adam state is ``(count, mu, nu)`` over the parameter tree, a
    ``torch.optim.Adam`` state is ``(step, exp_avg, exp_avg_sq)`` per
    parameter; behind ``optax.chain(clip_by_global_norm, adam)`` (PPO, A2C)
    the optax state sits one level deeper, after the clip's empty state.

Both directions are exact (pure permutations), so a round trip returns the
bits it was given. The GRU NPC policy (``npc/policy_net.py``) goes across
under the same rules, with its key set checked against ``NpcGRU``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from torchdriveenv_tpu_torch.models.cnn import conv_out_res
from torchdriveenv_tpu_torch.npc.policy_net import NpcGRU

_CONV3_CHANNELS = 64
SAC_PARAM_KEYS = (("actor_params", "actor"), ("critic_params", "critic"),
                  ("target_critic_params", "target_critic"))
SAC_OPT_KEYS = ("actor_opt", "critic_opt", "alpha_opt")
TD3_PARAM_KEYS = (("actor_params", "actor"),
                  ("target_actor_params", "target_actor"),
                  ("critic_params", "critic"),
                  ("target_critic_params", "target_critic"))
TD3_OPT_KEYS = ("actor_opt", "critic_opt")


def _is_torso_fc(path) -> bool:
    return bool(path) and path[-1] == "fc"     # NatureCNN's only dense layer


def _kernel_to_torch(path, k: np.ndarray, obs_res: int) -> np.ndarray:
    if k.ndim == 4:                                   # HWIO -> OIHW
        return k.transpose(3, 2, 0, 1)
    if _is_torso_fc(path):                            # rows (h, w, c) -> (c, h, w)
        s, c = conv_out_res(obs_res), _CONV3_CHANNELS
        return k.reshape(s, s, c, -1).transpose(3, 2, 0, 1).reshape(
            k.shape[1], -1)
    return k.T


def _kernel_from_torch(path, w: np.ndarray, obs_res: int) -> np.ndarray:
    if w.ndim == 4:                                   # OIHW -> HWIO
        return w.transpose(2, 3, 1, 0)
    if _is_torso_fc(path):
        s, c = conv_out_res(obs_res), _CONV3_CHANNELS
        return w.reshape(-1, c, s, s).transpose(2, 3, 1, 0).reshape(
            -1, w.shape[0])
    return w.T


def params_to_torch(tree: Mapping[str, Any], obs_res: int = 64
                    ) -> Dict[str, torch.Tensor]:
    """JAX-layout parameter tree (with or without the ``"params"`` root) ->
    ``state_dict`` of the module of the same name in this package."""
    tree = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for name, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (name,))
                continue
            v = np.asarray(v)
            if name == "kernel":
                key, v = path + ("weight",), _kernel_to_torch(path, v, obs_res)
            else:                     # "bias", or a bare parameter (log_std)
                key = path + (name,)
            out[".".join(key)] = torch.from_numpy(np.array(v))     # a C-order copy

    walk(tree, ())
    return out


def params_from_torch(state_dict: Mapping[str, torch.Tensor],
                      obs_res: int = 64) -> Dict[str, Any]:
    """``state_dict`` -> ``{"params": nested dict}`` in the JAX layout."""
    root: Dict[str, Any] = {}
    for key, t in state_dict.items():
        *path, name = key.split(".")
        v = t.detach().cpu().numpy()
        node = root
        for p in path:
            node = node.setdefault(p, {})
        if name == "weight":
            name, v = "kernel", _kernel_from_torch(tuple(path), v, obs_res)
        node[name] = np.ascontiguousarray(v)
    return {"params": root}


def _check_npc_keys(state: Mapping[str, Any]) -> None:
    want = {k: tuple(v.shape) for k, v in NpcGRU().state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    if got != want:
        raise ValueError(
            "not the GRU NPC policy's parameters: missing "
            f"{sorted(set(want) - set(got))}, unexpected "
            f"{sorted(set(got) - set(want))}, shapes differ at "
            f"{sorted(k for k in set(got) & set(want) if got[k] != want[k])}")


def npc_params_to_torch(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's GRU NPC parameters (``{"params": {"GRUCell_0":
    {"ir": {"kernel" (9, 16), "bias"}, ..., "hr": {"kernel" (16, 16)}, ...},
    "Dense_0": ..., "Dense_1": ...}}``, as ``flax.serialization`` restores
    ``npc_gru_v1.msgpack``) -> ``NpcGRU``'s ``state_dict``."""
    state = params_to_torch(tree)
    _check_npc_keys(state)
    return state


def npc_params_from_torch(state_dict: Mapping[str, torch.Tensor]
                          ) -> Dict[str, Any]:
    """Inverse of ``npc_params_to_torch``: the tree the JAX package's
    ``NpcGRU`` applies."""
    _check_npc_keys(state_dict)
    return params_from_torch(state_dict)


def _adam_fields(opt):
    """(count, mu, nu) of an optax Adam state: the restored form
    ``[{"count", "mu", "nu"}, None]``, the dict alone, or the live
    ``(ScaleByAdamState, EmptyState)``; and each of these one level down,
    behind the empty state of a ``clip_by_global_norm`` chained in front
    (``[None, [{...}, None]]`` restored, ``(EmptyState, (ScaleByAdamState,
    EmptyState))`` live)."""
    node = _find_adam(opt)
    if node is None:
        raise ValueError("no Adam state in this optimizer state")
    if isinstance(node, Mapping):
        return node["count"], node["mu"], node["nu"]
    return node.count, node.mu, node.nu


def _find_adam(node):
    """The first part of an optax state, depth first, that holds Adam's
    fields: a dict with ``"count"`` or a named tuple with a ``count`` field."""
    if isinstance(node, Mapping):
        return node if "count" in node else None
    if "count" in getattr(node, "_fields", ()):
        return node
    if isinstance(node, (list, tuple)):
        for part in node:
            found = _find_adam(part)
            if found is not None:
                return found
    return None


def adam_to_torch(opt, obs_res: int = 64) -> Dict[str, Any]:
    """optax Adam state (plain or behind a clip) -> ``{"step": int,
    "exp_avg": state_dict-like, "exp_avg_sq": state_dict-like}``. The
    moments of a bare array (the temperature) come back under the key
    ``""``."""
    count, mu, nu = _adam_fields(opt)

    def moments(m):
        if isinstance(m, Mapping):
            return params_to_torch(m, obs_res)
        return {"": torch.from_numpy(np.array(m, dtype=np.float32))}

    return {"step": int(np.asarray(count)), "exp_avg": moments(mu),
            "exp_avg_sq": moments(nu)}


def adam_from_torch(adam: Mapping[str, Any], obs_res: int = 64,
                    chained: bool = False):
    """Inverse of ``adam_to_torch`` -> ``[{"count", "mu", "nu"}, None]``,
    the form a checkpoint of the JAX package restores to; with ``chained``,
    that of ``optax.chain(clip_by_global_norm, adam)``: ``[None, [...]]``."""
    def moments(m):
        if set(m) == {""}:
            return m[""].detach().cpu().numpy()
        return params_from_torch(m, obs_res)

    state = [{"count": np.asarray(adam["step"], np.int32),
              "mu": moments(adam["exp_avg"]),
              "nu": moments(adam["exp_avg_sq"])}, None]
    return [None, state] if chained else state


def sac_state_to_torch(tree: Mapping[str, Any], obs_res: int = 64
                       ) -> Dict[str, Any]:
    """A whole ``SACState`` of the JAX package (as numpy) -> what
    ``rl.sac.SAC.load_state`` takes: ``actor`` / ``critic`` /
    ``target_critic`` state dicts, ``log_alpha``, ``step`` and the three
    Adam states."""
    out: Dict[str, Any] = {dst: params_to_torch(tree[src], obs_res)
                           for src, dst in SAC_PARAM_KEYS}
    out["log_alpha"] = torch.from_numpy(
        np.array(tree["log_alpha"], dtype=np.float32))
    out["step"] = int(np.asarray(tree["step"]))
    for k in SAC_OPT_KEYS:
        out[k] = adam_to_torch(tree[k], obs_res)
    return out


def sac_state_from_torch(state: Mapping[str, Any], obs_res: int = 64
                         ) -> Dict[str, Any]:
    """Inverse of ``sac_state_to_torch``: the numpy tree a checkpoint of the
    JAX package holds."""
    out: Dict[str, Any] = {src: params_from_torch(state[dst], obs_res)
                           for src, dst in SAC_PARAM_KEYS}
    out["log_alpha"] = state["log_alpha"].detach().cpu().numpy()
    out["step"] = np.asarray(state["step"], np.int32)
    for k in SAC_OPT_KEYS:
        out[k] = adam_from_torch(state[k], obs_res)
    return out


def ppo_state_to_torch(tree: Mapping[str, Any], obs_res: int = 64
                       ) -> Dict[str, Any]:
    """A whole ``PPOState`` or ``A2CState`` of the JAX package (``params``,
    the chained ``opt``, ``step``; as numpy) -> what ``rl.ppo.PPO.load_state``
    and ``rl.a2c.A2C.load_state`` take: ``net``, ``opt``, ``step``."""
    return {"net": params_to_torch(tree["params"], obs_res),
            "opt": adam_to_torch(tree["opt"], obs_res),
            "step": int(np.asarray(tree["step"]))}


def ppo_state_from_torch(state: Mapping[str, Any], obs_res: int = 64
                         ) -> Dict[str, Any]:
    """Inverse of ``ppo_state_to_torch``: the numpy tree a checkpoint of the
    JAX package holds."""
    return {"params": params_from_torch(state["net"], obs_res),
            "opt": adam_from_torch(state["opt"], obs_res, chained=True),
            "step": np.asarray(state["step"], np.int32)}


a2c_state_to_torch = ppo_state_to_torch         # the same three fields
a2c_state_from_torch = ppo_state_from_torch


def td3_state_to_torch(tree: Mapping[str, Any], obs_res: int = 64
                       ) -> Dict[str, Any]:
    """A whole ``TD3State`` of the JAX package (as numpy) -> what
    ``rl.td3.TD3.load_state`` takes: the four state dicts, ``step`` and the
    two Adam states."""
    out: Dict[str, Any] = {dst: params_to_torch(tree[src], obs_res)
                           for src, dst in TD3_PARAM_KEYS}
    out["step"] = int(np.asarray(tree["step"]))
    for k in TD3_OPT_KEYS:
        out[k] = adam_to_torch(tree[k], obs_res)
    return out


def td3_state_from_torch(state: Mapping[str, Any], obs_res: int = 64
                         ) -> Dict[str, Any]:
    """Inverse of ``td3_state_to_torch``."""
    out: Dict[str, Any] = {src: params_from_torch(state[dst], obs_res)
                           for src, dst in TD3_PARAM_KEYS}
    out["step"] = np.asarray(state["step"], np.int32)
    for k in TD3_OPT_KEYS:
        out[k] = adam_from_torch(state[k], obs_res)
    return out
