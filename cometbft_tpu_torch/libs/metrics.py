"""Prometheus metrics primitives + exposition server
(reference: libs/metrics + the go-kit/prometheus providers each subsystem's
metrics.go instantiates; exposition served like node/node.go:385-387), the
port's copy of ``cometbft_tpu/libs/metrics.py``: the same text exposition,
byte for byte, for the same operations.

Self-contained (no prometheus_client in the image): Counter/Gauge/Histogram
with label support, a GaugeFunc for scrape-time sampling of live objects
(mempool size, peer count — cheaper than write-path instrumentation), and a
text-format (version 0.0.4) HTTP endpoint.

A sampler that raises leaves its sample out, as the reference's does; the
port counts it on the registry (``sample_errors``, ``last_sample_error``),
where the reference passes over it.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from cometbft_tpu_torch.libs import threads


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() else repr(f)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str = "", label_names: tuple = ()):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._children: dict[tuple, object] = {}
        self._mtx = threading.Lock()

    def labels(self, **kv):
        key = tuple(str(kv[n]) for n in self.label_names)
        with self._mtx:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                self._children[key] = child
            return child

    def _default(self):
        return self.labels() if not self.label_names else None

    def _samples(self):
        """Yield (suffix, labels-dict, value) triples."""
        with self._mtx:
            items = list(self._children.items())
        for key, child in items:
            labels = dict(zip(self.label_names, key))
            yield from child._child_samples(labels)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        for suffix, labels, value in self._samples():
            lines.append(f"{self.name}{suffix}{_fmt_labels(labels)} {_fmt_value(value)}")
        return "\n".join(lines)


class _CounterChild:
    def __init__(self):
        self._v = 0.0
        self._mtx = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._mtx:
            self._v += n

    def _child_samples(self, labels):
        yield "", labels, self._v


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, n: float = 1.0) -> None:
        self.labels().inc(n)


class _GaugeChild:
    def __init__(self):
        self._v = 0.0
        self._mtx = threading.Lock()

    def set(self, v: float) -> None:
        with self._mtx:
            self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._mtx:
            self._v += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def _child_samples(self, labels):
        yield "", labels, self._v


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, v: float) -> None:
        self.labels().set(v)

    def inc(self, n: float = 1.0) -> None:
        self.labels().inc(n)

    def dec(self, n: float = 1.0) -> None:
        self.labels().dec(n)


class GaugeFunc(_Metric):
    """Scrape-time gauge: samples a callable at render time."""

    kind = "gauge"

    def __init__(self, name: str, help_text: str, fn, owner=None):
        super().__init__(name, help_text)
        self._fn = fn
        self._owner = owner

    def _samples(self):
        try:
            v = float(self._fn())
        except Exception as e:  # counted on the registry, the sample left out
            if self._owner is not None:
                self._owner.count_sample_error(e)
            return
        yield "", {}, v


DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10)


class _HistogramChild:
    def __init__(self, buckets):
        self.buckets = buckets
        self._counts = [0] * (len(buckets) + 1)
        self._sum = 0.0
        self._n = 0
        self._mtx = threading.Lock()

    def observe(self, v: float) -> None:
        with self._mtx:
            self._sum += v
            self._n += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def _child_samples(self, labels):
        with self._mtx:
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += self._counts[i]
                yield "_bucket", {**labels, "le": _fmt_value(b)}, cum
            cum += self._counts[-1]
            yield "_bucket", {**labels, "le": "+Inf"}, cum
            yield "_sum", labels, self._sum
            yield "_count", labels, self._n


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_text="", label_names=(), buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_text, label_names)
        self.buckets = tuple(buckets)

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float) -> None:
        self.labels().observe(v)


class Registry:
    def __init__(self, namespace: str = ""):
        self.namespace = namespace
        self._metrics: list[_Metric] = []
        self._mtx = threading.Lock()
        self.sample_errors = 0
        self.last_sample_error: BaseException | None = None

    def count_sample_error(self, e: BaseException) -> None:
        """A scrape-time sampler raised: its sample is left out (or 0 where
        the sampler falls back to it), and the exception counted here."""
        with self._mtx:
            self.sample_errors += 1
            self.last_sample_error = e

    def _full_name(self, subsystem: str, name: str) -> str:
        parts = [p for p in (self.namespace, subsystem, name) if p]
        return "_".join(parts)

    def counter(self, subsystem: str, name: str, help_text: str = "", labels=()) -> Counter:
        return self._add(Counter(self._full_name(subsystem, name), help_text, labels))

    def gauge(self, subsystem: str, name: str, help_text: str = "", labels=()) -> Gauge:
        return self._add(Gauge(self._full_name(subsystem, name), help_text, labels))

    def gauge_func(self, subsystem: str, name: str, help_text: str, fn) -> GaugeFunc:
        return self._add(
            GaugeFunc(self._full_name(subsystem, name), help_text, fn, owner=self)
        )

    def histogram(
        self, subsystem: str, name: str, help_text: str = "", labels=(),
        buckets=DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._add(
            Histogram(self._full_name(subsystem, name), help_text, labels, buckets)
        )

    def _add(self, m: _Metric):
        with self._mtx:
            self._metrics.append(m)
        return m

    def render(self) -> str:
        with self._mtx:
            metrics = list(self._metrics)
        return "\n".join(m.render() for m in metrics) + "\n"


class MetricsServer:
    """The /metrics endpoint (node/node.go:385 startPrometheusServer)."""

    def __init__(self, registry: Registry, host: str = "127.0.0.1", port: int = 26660):
        self.registry = registry
        self.host = host
        self.port = port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        registry = self.registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib casing)
                if self.path.split("?")[0] != "/metrics":
                    self.send_response(404)
                    self.end_headers()
                    return
                body = registry.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr lines
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        if self.port == 0:
            self.port = self._httpd.server_address[1]
        # In the caller's thread group: a node's stop() joins it.
        self._thread = threads.spawn(self._httpd.serve_forever, name="metrics-server")

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(10)
