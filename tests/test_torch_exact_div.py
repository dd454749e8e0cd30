"""Division by a Python number, as the JAX package rounds it, on any device.

torch's CUDA kernels turn ``x / 0.1`` into ``x * (1 / 0.1)``: an ulp off
the IEEE quotient in about half the cases, where the CPU and XLA divide.
The port divides by a number through ``maps.arrays.exact_div`` (a divisor
tensor on ``x``'s device), so the card rounds as the CPU does; ``chip_smoke.py``
``[parity]`` checks that on the card. Here: the helper equals numpy's float32
division where the reciprocal product does not, and no module of the port
divides a tensor by a number that is not a power of two any other way.
"""

import ast
import glob
import importlib
import math
import os

import numpy as np
import pytest
import torch

from torchdriveenv_tpu_torch.maps.arrays import exact_div
from torchdriveenv_tpu_torch.npc import route_follow as rf

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "torchdriveenv_tpu_torch")
# the divisors of the port's env step, NPC features, scripted drivers, CNN
# input and PPO advantages
DIVISORS = (0.1, 10.0, 22.0, 30.0, 40.0, 60.0, 255.0, rf._IDM_DENOM, 1000)
# divisions whose operands are Python numbers (no tensor is divided)
PYTHON_ONLY = {
    ("bench.py", "tot / 1000.0"),
    ("models/cnn.py", "math.sqrt(1.0 / fan_in) / 0.8796256610342398"),
    ("tools/compile_assets.py", "os.path.getsize(p) / 1000000.0"),
}


def _values():
    rng = np.random.default_rng(0)
    return np.concatenate([
        np.arange(256, dtype=np.float32),
        rng.uniform(-80.0, 80.0, 20000).astype(np.float32),
        np.linspace(0.0, 30.0, 4001, dtype=np.float32)])


@pytest.mark.parametrize("divisor", DIVISORS)
def test_exact_div_is_one_ieee_rounding(divisor):
    x = _values()
    want = x / np.float32(divisor)
    got = exact_div(torch.from_numpy(x), divisor).numpy()
    np.testing.assert_array_equal(got, want)
    # what torch's CUDA kernels compute for ``x / divisor``: these inputs
    # tell the two apart wherever the reciprocal is inexact
    recip = x * np.float32(np.float32(1.0) / np.float32(divisor))
    exact_recip = math.frexp(divisor)[0] == 0.5
    assert (recip != want).any() != exact_recip


def test_exact_div_keeps_the_dtype_and_shape():
    x = torch.arange(24, dtype=torch.bfloat16).reshape(2, 3, 4)
    got = exact_div(x, 255.0)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got, x / 255.0)           # the CPU divides exactly
    assert exact_div(torch.tensor(3.0), 0.1).shape == ()


def _number_divisors(path, tree):
    """Every division by a number literal or a module constant (a
    capitalised name) whose value is not a power of two."""
    mod = None
    for node in ast.walk(tree):
        if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div)):
            continue
        r = node.right
        if isinstance(r, ast.UnaryOp) and isinstance(r.op, ast.USub):
            r = r.operand
        if isinstance(r, ast.Constant) and isinstance(r.value, (int, float)):
            value = r.value
        elif isinstance(r, ast.Name) and r.id.lstrip("_").isupper():
            if mod is None:
                rel = os.path.relpath(path, os.path.dirname(PORT))
                mod = importlib.import_module(
                    rel[:-3].replace(os.sep, "."))
            value = getattr(mod, r.id, None)
            if not isinstance(value, (int, float)):
                continue
        else:
            continue
        if value and math.frexp(float(value))[0] != 0.5:
            yield ast.unparse(node)


def test_no_tensor_is_divided_by_a_number_any_other_way():
    found = []
    for path in sorted(glob.glob(os.path.join(PORT, "**", "*.py"),
                                 recursive=True)):
        with open(path) as f:
            tree = ast.parse(f.read())
        rel = os.path.relpath(path, PORT).replace(os.sep, "/")
        for expr in _number_divisors(path, tree):
            if (rel, expr) not in PYTHON_ONLY:
                found.append(f"{rel}: {expr}")
    assert not found, found
