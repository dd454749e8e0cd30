"""The run's entry: no card, no result; a checkout without the port, no
result; nothing of JAX or the JAX package loaded, by whole top-level
name."""

import json
import os
import shutil
import subprocess
import sys


from benchmark import manifest, run


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         manifest.load_manifest()["workloads"][0]["name"], "--seed",
         "2147483700", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _no_result(p):
    for line in p.stdout.splitlines():
        try:
            assert not isinstance(json.loads(line), dict)
        except json.JSONDecodeError:
            pass


def test_no_card_no_result():
    p = _run(manifest.ROOT)
    assert p.returncode == run.EXIT_NO_CARD, p.stderr
    _no_result(p)
    assert "CUDA card" in p.stderr


def test_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(manifest.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(str(tmp_path))
    assert p.returncode != 0
    _no_result(p)


def test_banned_names_compared_whole():
    mods = ["torchdriveenv_tpu_torch", "torchdriveenv_tpu_torch.env.core",
            "jaxlib.xla_client", "jax", "torchdriveenv_tpu.env", "jaxtyping",
            "flax.linen", "flaxen"]
    assert run.banned_modules(mods) == sorted(
        ["jaxlib.xla_client", "jax", "torchdriveenv_tpu.env", "flax.linen"])


_PROBE = """
import json, sys
{body}
print(json.dumps(sorted(sys.modules)))
"""


def _modules_after(body):
    p = subprocess.run([sys.executable, "-c", _PROBE.format(body=body)],
                       cwd=manifest.ROOT, capture_output=True, text=True,
                       timeout=600, env=dict(os.environ,
                                             CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 0, p.stderr
    return json.loads(p.stdout.splitlines()[-1])


def test_reference_loads_nothing_of_the_port_or_jax():
    mods = _modules_after(
        "import benchmark.reference.env, benchmark.reference.lowp\n"
        "import benchmark.compare")
    tops = {m.split(".", 1)[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "flax", "torchdriveenv_tpu",
                       "torchdriveenv_tpu_torch"}


def test_a_run_loads_nothing_of_jax():
    body = (
        "from benchmark import run\n"
        "a = run.parse(['--workload', 'env_main.gru_explore', '--seed', '5',"
        " '--seconds', '0.5'])\n"
        "c = run.context(a, 'cpu', sizes={'num_envs': 4, 'env': "
        "{'reset_pool': 2}})\n"
        "line = run.run_cell(c)\n"
        "assert not run.banned_modules(), run.banned_modules()\n")
    mods = _modules_after(body)
    assert "torchdriveenv_tpu_torch" in mods
    assert not run.banned_modules(mods)
