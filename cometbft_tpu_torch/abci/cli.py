"""abci-cli: exercise an ABCI server from the command line
(abci/cmd/abci-cli/abci-cli.go in CometBFT), the port's copy of
``cometbft_tpu/abci/cli.py``: the same commands and output.

Batch mode:   python -m cometbft_tpu_torch.abci.cli --addr tcp://... echo hello
Console mode: python -m cometbft_tpu_torch.abci.cli --addr tcp://... console

Commands: echo <msg> | info | deliver_tx <tx> | check_tx <tx> | commit |
query <key> | prepare_proposal <tx>... | process_proposal <tx>... — tx/key
accept 0xHEX or raw strings, like abci-cli's parsing."""

from __future__ import annotations

import argparse
import shlex
import sys

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.client import SocketClient


def _arg_bytes(s: str) -> bytes:
    if s.startswith("0x"):
        return bytes.fromhex(s[2:])
    return s.encode()


def _print_resp(resp) -> None:
    pairs = []
    for k in ("code", "log", "info", "message", "data", "value", "key", "height"):
        v = getattr(resp, k, None)
        if v in (None, "", b"", 0) and k != "code":
            continue
        if isinstance(v, bytes):
            v = "0x" + v.hex().upper()
        pairs.append(f"{k}: {v}")
    if hasattr(resp, "txs"):
        pairs.append(f"txs: {[t.decode('utf-8', 'replace') for t in resp.txs]}")
    if hasattr(resp, "status"):
        pairs.append(f"status: {resp.status}")
    print("-> " + "\n-> ".join(pairs or [type(resp).__name__]))


_NEEDS_ARG = {"deliver_tx", "check_tx", "query"}


def run_command(client: SocketClient, parts: list[str]) -> int:
    cmd, args = parts[0], parts[1:]
    if cmd in _NEEDS_ARG and not args:
        print(f"usage: {cmd} <arg>", file=sys.stderr)
        return 1
    if cmd == "echo":
        _print_resp(client.echo(args[0] if args else ""))
    elif cmd == "info":
        _print_resp(client.info(abci.RequestInfo(version="abci-cli")))
    elif cmd == "deliver_tx":
        _print_resp(client.deliver_tx(abci.RequestDeliverTx(tx=_arg_bytes(args[0]))))
    elif cmd == "check_tx":
        _print_resp(client.check_tx(abci.RequestCheckTx(tx=_arg_bytes(args[0]))))
    elif cmd == "commit":
        _print_resp(client.commit())
    elif cmd == "query":
        _print_resp(
            client.query(abci.RequestQuery(path="/store", data=_arg_bytes(args[0])))
        )
    elif cmd == "prepare_proposal":
        _print_resp(
            client.prepare_proposal(
                abci.RequestPrepareProposal(
                    max_tx_bytes=1 << 20, txs=[_arg_bytes(a) for a in args]
                )
            )
        )
    elif cmd == "process_proposal":
        _print_resp(
            client.process_proposal(
                abci.RequestProcessProposal(txs=[_arg_bytes(a) for a in args])
            )
        )
    elif cmd in ("help", "?"):
        print(__doc__)
    else:
        print(f"unknown command {cmd!r} (try help)", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="abci-cli")
    p.add_argument("--addr", default="tcp://127.0.0.1:26658")
    p.add_argument(
        "--transport",
        choices=["socket", "grpc"],
        default=None,
        help="defaults to socket, or grpc when --addr is grpc://",
    )
    p.add_argument("command", nargs="*", help="command, or 'console'")
    args = p.parse_args(argv)
    transport = args.transport or (
        "grpc" if args.addr.startswith("grpc://") else "socket"
    )
    if transport == "grpc":
        from cometbft_tpu_torch.abci.grpc import GrpcClient

        client = GrpcClient(args.addr, connect_timeout=5.0)
    else:
        client = SocketClient(args.addr, connect_timeout=5.0)
    try:
        if not args.command or args.command[0] == "console":
            print(f"connected to {args.addr}; 'help' for commands, ctrl-d to exit")
            while True:
                try:
                    line = input("> ")
                except EOFError:
                    return 0
                parts = shlex.split(line)
                if parts:
                    run_command(client, parts)
        return run_command(client, args.command)
    finally:
        client.close()


if __name__ == "__main__":
    sys.exit(main())
