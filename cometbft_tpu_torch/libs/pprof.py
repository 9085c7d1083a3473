"""Runtime profiling endpoints, the net/http/pprof analog.

Counterpart of ``cometbft_tpu/libs/pprof.py``: the same Python profiles,
and the card's through PyTorch in place of JAX's:

  /debug/pprof/            index
  /debug/pprof/goroutine   every thread's current stack (threads are the
                           goroutine analog here)
  /debug/pprof/heap        tracemalloc top allocations (started on demand)
  /debug/pprof/profile     wall-clock sampling profile over ?seconds=N
                           (default 5): samples sys._current_frames and
                           aggregates frame stacks, text output
  /debug/torch/memory      per-card allocator stats (torch.cuda.memory_stats);
                           a host without a card says so
  /debug/torch/trace       a torch.profiler trace (CPU and CUDA activities)
                           over ?seconds=N, written as a Chrome trace into
                           ?dir= (default ``torch-trace``), loadable in
                           Perfetto or chrome://tracing: every kernel the
                           process launched in the window, from any thread
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


def thread_stacks() -> str:
    """All live thread stacks (the goroutine dump analog)."""
    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        t = by_ident.get(ident)
        name = t.name if t else f"thread-{ident}"
        daemon = " daemon" if (t and t.daemon) else ""
        out.append(f"--- {name} (ident {ident}{daemon}) ---")
        out.append("".join(traceback.format_stack(frame)))
    return "\n".join(out)


def sample_profile(seconds: float = 5.0, hz: int = 100) -> str:
    """Wall-clock sampling profiler: aggregate stack samples across all
    threads for ``seconds``, report the hottest stacks (pprof's 'profile'
    without a C agent)."""
    counts: Counter = Counter()
    interval = 1.0 / hz
    deadline = time.monotonic() + seconds
    n = 0
    while time.monotonic() < deadline:
        for frame in sys._current_frames().values():
            stack = []
            f = frame
            while f is not None and len(stack) < 24:
                qn = getattr(f.f_code, "co_qualname", f.f_code.co_name)
                stack.append(f"{f.f_code.co_filename}:{f.f_lineno}:{qn}")
                f = f.f_back
            counts[tuple(reversed(stack))] += 1
        n += 1
        time.sleep(interval)
    out = [f"# wall-clock samples: {n} over {seconds}s at ~{hz}Hz"]
    for stack, c in counts.most_common(40):
        out.append(f"\n{c} samples:")
        out.extend(f"  {line}" for line in stack[-12:])
    return "\n".join(out)


def heap_profile(top: int = 50) -> str:
    import tracemalloc

    if not tracemalloc.is_tracing():
        tracemalloc.start()
        return (
            "tracemalloc just started: allocations are tracked from NOW; "
            "re-request this endpoint after exercising the node."
        )
    snap = tracemalloc.take_snapshot()
    stats = snap.statistics("lineno")[:top]
    total = sum(s.size for s in snap.statistics("filename"))
    out = [f"# tracemalloc: {total / 1e6:.1f} MB tracked"]
    out.extend(str(s) for s in stats)
    return "\n".join(out)


def torch_memory() -> str:
    """One line a CUDA device: ``cuda:i (name): key=value, ...`` over
    ``torch.cuda.memory_stats(i)`` (the caching allocator's counters:
    allocated, reserved and active bytes, current and peak, and the rest)."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device: torch.cuda.is_available() is False"
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append(f"cuda:{i} ({torch.cuda.get_device_name(i)}): "
                   + ", ".join(f"{k}={v}" for k, v in sorted(stats.items())))
    return "\n".join(out)


def torch_trace(seconds: float, trace_dir: str) -> str:
    """Record a ``torch.profiler`` trace for ``seconds`` (CPU and, with a
    card, CUDA activities: every kernel the process launches in the window,
    from any thread) and write it as a Chrome trace into ``trace_dir``.
    Says where, and how many events and CUDA kernels it holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"torch-trace-{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        time.sleep(seconds)
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    events = prof.events()
    kernels = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    note = "" if cuda else " (no CUDA device: CPU activities only)"
    return (f"trace written to {path}: {len(events)} events, {kernels} CUDA kernel events"
            f"{note} (open with Perfetto or chrome://tracing)")


class PprofServer:
    """The /debug HTTP listener. Port 0 binds a free port, read back from
    ``port`` after ``start()``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6060, trace_dir: str = "torch-trace"):
        self.host, self.port = host, port
        self.trace_dir = trace_dir
        self._httpd = None

    def start(self) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                u = urlparse(self.path)
                q = parse_qs(u.query)
                try:
                    if u.path in ("/debug/pprof", "/debug/pprof/"):
                        body = (
                            "profiles:\n  goroutine\n  heap\n  profile?seconds=N\n"
                            "device:\n  /debug/torch/memory\n"
                            "  /debug/torch/trace?seconds=N&dir=DIR\n"
                        )
                    elif u.path == "/debug/pprof/goroutine":
                        body = thread_stacks()
                    elif u.path == "/debug/pprof/heap":
                        body = heap_profile()
                    elif u.path == "/debug/pprof/profile":
                        secs = float(q.get("seconds", ["5"])[0])
                        body = sample_profile(min(secs, 60.0))
                    elif u.path == "/debug/torch/memory":
                        body = torch_memory()
                    elif u.path == "/debug/torch/trace":
                        secs = float(q.get("seconds", ["3"])[0])
                        tdir = q.get("dir", [server.trace_dir])[0]
                        body = torch_trace(min(secs, 60.0), tdir)
                    else:
                        self.send_response(404)
                        self.end_headers()
                        return
                except Exception as e:
                    self.send_response(500)
                    self.end_headers()
                    self.wfile.write(str(e).encode())
                    return
                raw = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def log_message(self, *a):
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        if self.port == 0:
            self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
