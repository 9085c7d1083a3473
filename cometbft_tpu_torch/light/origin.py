"""BundleOrigin: the node side of checkpoint bundles, the port's copy of
``cometbft_tpu/light/origin.py``.

The light gateway (``light/gateway.py``) shares verification work but
answers every client itself. The origin instead FREEZES the accumulator at
checkpoint intervals (``CMTPU_BUNDLE_INTERVAL``, default 1000 heights) into
immutable, content-addressed artifacts (``light/bundle.py``) that any dumb
cache, file sync or peer replicates.

The origin and the gateway keep one chain accumulator the same way: a lazy
resume from the persisted MMR state file (``mmr.resume_or_new``, which
refuses a state that disagrees with the block store), a chunked
append-only catch-up (``mmr.catch_up``), an atomic re-save. Historical
checkpoint roots come from the SAME live accumulator through
``peaks_at`` / ``prove_at``.

Serving is bounded: the store of encoded bundles keeps the newest
``CMTPU_BUNDLE_KEEP`` checkpoints, and decoded bundles sit behind a small
refresh-on-reput LRU (``CMTPU_BUNDLE_CACHE``). ``CMTPU_BUNDLE=0`` disables
the subsystem. A header hash the source cannot give while resuming is
counted (``header_errors``, the last exception in ``last_header_error``)
before the resume refuses the state file.
"""
from __future__ import annotations

import json
import os
import threading

from cometbft_tpu_torch.light import mmr as mmr_mod
from cometbft_tpu_torch.light.bundle import (
    Bundle,
    BundleError,
    LadderHop,
    ladder_heights,
)
from cometbft_tpu_torch.light.provider import Provider
from cometbft_tpu_torch.types.light_block import LightBlock

_MMR_CATCHUP_CHUNK = 256


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def bundles_enabled() -> bool:
    return os.environ.get("CMTPU_BUNDLE", "1").strip().lower() not in (
        "0", "false", "off",
    )


def bundle_interval() -> int:
    return max(1, _env_int("CMTPU_BUNDLE_INTERVAL", 1000))


class BundleOrigin:
    """Builds and re-serves checkpoint bundles over a block-store-backed
    provider; see module docstring."""

    def __init__(
        self,
        chain_id: str,
        source: Provider,
        interval: int | None = None,
        keep: int | None = None,
        state_path: str | None = None,
        logger=None,
    ):
        self.chain_id = chain_id
        self.source = source
        self.interval = max(1, interval if interval is not None
                            else bundle_interval())
        self.keep = max(1, keep if keep is not None
                        else _env_int("CMTPU_BUNDLE_KEEP", 8))
        self.decoded_cache_max = max(1, _env_int("CMTPU_BUNDLE_CACHE", 4))
        self.state_path = state_path
        self.logger = logger
        self._mmr: mmr_mod.MMR | None = None
        self._mmr_lock = threading.Lock()
        # checkpoint height -> (name, encoded bytes); bounded to the
        # newest `keep` checkpoints (evict lowest height).
        self._encoded: dict[int, tuple[str, bytes]] = {}
        # checkpoint height -> decoded Bundle; insertion-ordered LRU,
        # refresh-on-reput (the verified-triple cache idiom).
        self._decoded: dict[int, Bundle] = {}
        self._store_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stats = {
            "bundles_built": 0,
            "bundle_hits": 0,
            "bundle_fallbacks": 0,
            "bundle_bytes_served": 0,
        }
        self.header_errors = 0
        self.last_header_error: BaseException | None = None

    def _bump(self, key: str, by: int = 1) -> None:
        with self._stats_lock:
            self._stats[key] += by

    # -- accumulator (shared discipline with LightGateway) -----------------

    def _fetch(self, height: int) -> LightBlock:
        try:
            lb = self.source.light_block(height)
        except Exception as e:
            raise BundleError(
                f"source has no light block {height}: {e}"
            ) from e
        lb.validate_basic(self.chain_id)
        return lb

    def _header_hash(self, height: int) -> bytes:
        fast = getattr(self.source, "header_hash", None)
        if fast is not None:
            h = fast(height)
            if h is not None:
                return h
        return self._fetch(height).hash()

    def _safe_header_hash(self, height: int) -> bytes | None:
        try:
            return self._header_hash(height)
        except Exception as e:
            with self._stats_lock:
                self.header_errors += 1
                self.last_header_error = e
            return None

    def _ensure_mmr(self) -> int:
        """Resume/extend the accumulator to the source tip; returns the
        tip height.  Raises BundleError (pruned source, unusable state
        file — refuse loudly, never rebuild over a mismatch)."""
        base_fn = getattr(self.source, "base_height", None)
        if base_fn is not None:
            base = int(base_fn() or 1)
            if base > 1:
                raise BundleError(
                    f"source history pruned below height {base}; bundles "
                    "need the full chain from height 1"
                )
        try:
            latest = self.source.light_block(0).height
        except Exception as e:
            raise BundleError(f"source tip unavailable: {e}") from e
        with self._mmr_lock:
            if self._mmr is None:
                try:
                    self._mmr = mmr_mod.resume_or_new(
                        self.state_path, self._safe_header_hash
                    )
                except mmr_mod.MMRStateError as e:
                    raise BundleError(str(e)) from e
        grew = mmr_mod.catch_up(
            self._mmr, self._mmr_lock, latest, self._header_hash,
            chunk=_MMR_CATCHUP_CHUNK,
        )
        if grew and self.state_path:
            with self._mmr_lock:
                mmr_mod.save_state(self._mmr, self.state_path)
        return latest

    # -- checkpoints -------------------------------------------------------

    def checkpoint_height(self, tip: int, at: int = 0) -> int:
        """Largest interval boundary <= min(tip, at or tip); 0 = none."""
        ceiling = min(tip, at) if at else tip
        return (ceiling // self.interval) * self.interval

    def _build(self, boundary: int) -> tuple[str, bytes]:
        """Freeze the accumulator at `boundary` into one artifact.  Caller
        holds _store_lock (builds are per-interval-rare; serialize them)."""
        anchor = self._fetch(boundary)
        with self._mmr_lock:
            peaks = [p for _, p in self._mmr.peaks_at(boundary)]
            proofs = {
                h: self._mmr.prove_at(h - 1, boundary)
                for h in ladder_heights(boundary)
            }
        ladder = []
        for h, proof in proofs.items():
            digest = anchor.hash() if h == boundary else self._header_hash(h)
            ladder.append(LadderHop(height=h, header_hash=digest,
                                    aunts=list(proof.aunts)))
        bundle = Bundle(
            chain_id=self.chain_id,
            anchor=anchor,
            mmr_size=boundary,
            peaks=peaks,
            ladder=ladder,
        )
        data = bundle.encode()
        self._encoded[boundary] = (bundle.name, data)
        while len(self._encoded) > self.keep:
            self._encoded.pop(min(self._encoded))
        self._bump("bundles_built")
        if self.logger:
            self.logger.info(
                "checkpoint bundle built", module="light",
                height=boundary, name=bundle.name[:16],
                bytes=len(data),
            )
        return bundle.name, data

    def get_encoded(self, height: int = 0) -> tuple[str, bytes, int]:
        """(name, bytes, checkpoint_height) of the best checkpoint at or
        below `height` (0 = latest).  Raises BundleError when no
        checkpoint exists yet — callers count that as a fallback."""
        try:
            tip = self._ensure_mmr()
            boundary = self.checkpoint_height(tip, height)
            if boundary < 1:
                raise BundleError(
                    f"no checkpoint at or below height {height or tip} "
                    f"(tip {tip}, interval {self.interval})"
                )
            with self._store_lock:
                ent = self._encoded.get(boundary)
                if ent is None:
                    ent = self._build(boundary)
            name, data = ent
        except BundleError:
            self._bump("bundle_fallbacks")
            raise
        self._bump("bundle_hits")
        self._bump("bundle_bytes_served", len(data))
        return name, data, boundary

    def get(self, height: int = 0) -> Bundle:
        """Decoded-bundle LRU over get_encoded."""
        name, data, boundary = self.get_encoded(height)
        with self._store_lock:
            b = self._decoded.pop(boundary, None)
            if b is None:
                b = Bundle.decode(data)
            while len(self._decoded) >= self.decoded_cache_max:
                self._decoded.pop(next(iter(self._decoded)))
            self._decoded[boundary] = b  # refresh-on-reput
        return b

    def bundle(self, height: int = 0) -> bytes | None:
        """BundleSource duck type (light/bundle.py) — an in-process client
        syncs straight off its node's origin."""
        try:
            return self.get_encoded(height)[1]
        except BundleError:
            return None

    # -- flat-directory export (the CDN shape) -----------------------------

    def export(self, out_dir: str, at: int = 0) -> dict:
        """Write every retained checkpoint as `<name>.bundle` plus an
        `index.json` into `out_dir` — the exact layout DirBundleSource
        reads and any dumb HTTP cache replicates.  Returns the index."""
        tip = self._ensure_mmr()
        top = self.checkpoint_height(tip, at)
        if top < 1:
            raise BundleError(
                f"nothing to export: tip {tip} below interval {self.interval}"
            )
        boundaries = list(range(self.interval, top + 1, self.interval))
        boundaries = boundaries[-self.keep:]
        os.makedirs(out_dir, exist_ok=True)
        index: dict = {
            "chain_id": self.chain_id,
            "interval": self.interval,
            "bundles": {},
        }
        for b in boundaries:
            with self._store_lock:
                ent = self._encoded.get(b)
                if ent is None:
                    ent = self._build(b)
            name, data = ent
            path = os.path.join(out_dir, f"{name}.bundle")
            if not os.path.exists(path):
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
            index["bundles"][str(b)] = name
        index["latest"] = index["bundles"][str(boundaries[-1])]
        tmp = os.path.join(out_dir, f"index.json.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(index, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(out_dir, "index.json"))
        return index

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self._stats)
        with self._store_lock:
            out["bundles_stored"] = len(self._encoded)
        with self._mmr_lock:
            out["mmr_size"] = self._mmr.size if self._mmr is not None else 0
        out["interval"] = self.interval
        out["keep"] = self.keep
        return out
