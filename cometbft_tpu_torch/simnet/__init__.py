"""simnet: deterministic virtual-clock network simulation, the port's copy
of ``cometbft_tpu/simnet``.

* :mod:`cometbft_tpu_torch.simnet.clock` — the ``Clock`` abstraction every
  consensus timer goes through: ``MonotonicClock`` (wall time, the
  default) and ``SimClock`` (an event-heap virtual clock that advances only
  when every registered actor is blocked, so simulated seconds cost only
  the host time needed to drain the events they contain).
* :mod:`cometbft_tpu_torch.simnet.transport` — ``SimTransport``/``SimConn``:
  the ``MultiplexTransport``/``UpgradedConn`` surface over in-memory pipes
  with a seeded per-link latency/jitter/bandwidth/drop model and
  runtime-scriptable partitions and heals, under ``SimNetwork``.
* :mod:`cometbft_tpu_torch.simnet.scenario` — the deterministic scenario
  harness: 50-200 in-process validators on ONE ``SimClock``, WAN latency
  matrices, partition/churn schedules and byzantine actors
  (:mod:`~cometbft_tpu_torch.simnet.byzantine`), replayable bit-identically
  from the seed.
"""

from cometbft_tpu_torch.simnet.clock import Clock, MonotonicClock, SimClock

__all__ = [
    "Clock",
    "MonotonicClock",
    "SimClock",
    "SimNetwork",
    "SimTransport",
    "run_scenario",
]


def __getattr__(name):
    # Lazy: scenario/transport import consensus+p2p, which themselves import
    # simnet.clock — an eager import here would be circular.
    if name in ("SimNetwork", "SimTransport"):
        from cometbft_tpu_torch.simnet import transport

        return getattr(transport, name)
    if name == "run_scenario":
        from cometbft_tpu_torch.simnet.scenario import run_scenario

        return run_scenario
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
