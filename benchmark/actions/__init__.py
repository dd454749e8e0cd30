"""The ego actions of a traffic mix, one module per ``kind``: a traffic
file's ``"actions": {"kind": "<kind>", ...}`` names
``benchmark/actions/<kind>.py``, and ``benchmark.gen.action_source`` finds it
by that name. A new kind is a new file here; no other file changes.

Each module has ``make(spec, *, num_envs, seed, device, cfg, assets)``,
called once in set-up (``spec`` is the traffic file's ``actions`` group,
``cfg`` and ``assets`` the program's env configuration and assets). It
returns ``None`` where the driver's learner chooses the actions, or a
callable ``actions(state, k) -> (num_envs, 2) float32`` for step ``k`` of
the run (warm-up included) from the env state the step starts from. What
it draws, it draws in set-up or from a generator of its own, seeded from
``seed`` (``benchmark.gen.generator(seed, gen.ACTION_STREAM, device)``), so
the env's draws stay the program's."""
