"""Deployments: ``deployments/<backend>.py``, found by the configuration's
``index.backend`` (``ivf`` where it names none).  A new one is a new file
here; ``setup`` is a ``cell.Setup``; a number a hook returns is compared
where the configuration's ``limits`` name it.  A file holds:

- ``METRICS``, the distances its reference computes; ``BUILD_FAULTS``,
  faults planted while the port builds; ``TINY``, the configuration's
  blocks at a size at which ``tests/test_pb_verdict.py`` finds the port
  correct and the control and every fault not;
- ``build(config, base_host, seed, device, fault)`` -> ``(backend,
  build_s)``: the port's index over the raw base, ``fault`` planted, its
  seconds ending in a synchronize;
- ``serve(setup)``, optional: run once the batcher is made;
- ``program_numbers(setup)``: compared numbers read off the port's state
  after the window, before it is freed; ``run_fields(setup)``: what the
  per-layer readers find on ``cell.Run`` besides its own fields;
- ``reference(setup)``: the plain reference; ``search(queries,
  precision)`` serves ``"fp64"`` (the verdict) and ``"tf32"`` (the
  control), ``exact(queries)`` the exact k; ``index_numbers(setup,
  reference)``: compared numbers it works out once the port is freed;
- ``judge(setup, answers, window, served)``, optional: the served numbers
  where the right answer depends on when it was served (the driver's
  writes, stamps it kept), in place of ``cell.served_numbers``.
"""
