"""simnet: deterministic virtual-clock network simulation, the port's copy
of ``cometbft_tpu/simnet``.

* :mod:`cometbft_tpu_torch.simnet.clock` — the ``Clock`` abstraction every
  consensus timer goes through: ``MonotonicClock`` (wall time, the
  default) and ``SimClock`` (an event-heap virtual clock that advances only
  when every registered actor is blocked, so simulated seconds cost only
  the host time needed to drain the events they contain).
* :mod:`cometbft_tpu_torch.simnet.scenario` — the deterministic scenario
  harness: 50-200 in-process validators on ONE ``SimClock``, WAN latency
  matrices, partition/churn schedules and byzantine actors
  (:mod:`~cometbft_tpu_torch.simnet.byzantine`), replayable bit-identically
  from the seed.

``SimNetwork`` and ``SimTransport`` (the reference's
``simnet/transport.py``, the p2p transport over in-memory pipes) are not
ported yet: they wait for the p2p slice, and naming them raises.
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
    # Lazy: the scenario imports consensus, which imports simnet.clock — an
    # eager import here would be circular.
    if name in ("SimNetwork", "SimTransport"):
        raise NotImplementedError(
            f"simnet.{name} lives in simnet/transport.py, which is not ported "
            "to cometbft_tpu_torch yet (it waits for the p2p slice)"
        )
    if name == "run_scenario":
        from cometbft_tpu_torch.simnet.scenario import run_scenario

        return run_scenario
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
