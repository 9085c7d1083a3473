"""`tomllib` fallback for Python < 3.11, the port's copy of
``cometbft_tpu/libs/tomlcompat.py``.

The stdlib gained tomllib in 3.11.  Everything
this repo reads back is TOML it wrote itself (config/toml.py render_toml,
e2e_generator.render_toml) or hand-written test manifests in the same
subset: comments, ``[section]`` / ``[dotted.section]`` headers, bare keys,
basic strings, ints, floats, booleans, and one-line arrays of those.  This
module parses exactly that subset strictly (unknown syntax raises, same
duplicate-table rules as tomllib) and defers to the real tomllib when it
exists, so behavior upgrades transparently on newer interpreters.
"""

from __future__ import annotations

try:  # pragma: no cover - exercised only on 3.11+
    from tomllib import TOMLDecodeError, load, loads  # noqa: F401
except ModuleNotFoundError:

    class TOMLDecodeError(ValueError):
        pass

    def load(fp) -> dict:
        data = fp.read()
        if isinstance(data, bytes):
            data = data.decode("utf-8")
        else:
            raise TypeError("load() expects a binary file object")
        return loads(data)

    def loads(text: str) -> dict:
        root: dict = {}
        table = root
        declared: set[tuple[str, ...]] = set()
        for ln, raw_line in enumerate(text.splitlines(), 1):
            line = raw_line.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("["):
                if not line.endswith("]") or line.startswith("[["):
                    raise TOMLDecodeError(f"line {ln}: unsupported table header")
                parts = tuple(p.strip() for p in line[1:-1].split("."))
                if not all(_is_bare_key(p) for p in parts):
                    raise TOMLDecodeError(f"line {ln}: bad table name {line!r}")
                if parts in declared:
                    raise TOMLDecodeError(
                        f"line {ln}: cannot declare {'.'.join(parts)} twice"
                    )
                declared.add(parts)
                table = root
                for p in parts:
                    nxt = table.setdefault(p, {})
                    if not isinstance(nxt, dict):
                        raise TOMLDecodeError(
                            f"line {ln}: {p!r} is already a value"
                        )
                    table = nxt
                continue
            key, sep, rest = line.partition("=")
            key = key.strip()
            if not sep or not _is_bare_key(key):
                raise TOMLDecodeError(f"line {ln}: expected `key = value`")
            if key in table:
                raise TOMLDecodeError(f"line {ln}: duplicate key {key!r}")
            value, rest = _parse_value(rest.strip(), ln)
            rest = rest.strip()
            if rest and not rest.startswith("#"):
                raise TOMLDecodeError(f"line {ln}: trailing junk {rest!r}")
            table[key] = value
        return root

    def _is_bare_key(k: str) -> bool:
        return bool(k) and all(c.isalnum() or c in "-_" for c in k)

    def _parse_value(s: str, ln: int):
        """One value at the head of `s` -> (value, remainder)."""
        if not s:
            raise TOMLDecodeError(f"line {ln}: missing value")
        if s[0] == '"':
            out, i = [], 1
            while i < len(s):
                c = s[i]
                if c == "\\":
                    if i + 1 >= len(s):
                        break
                    esc = s[i + 1]
                    mapped = {
                        "\\": "\\", '"': '"', "n": "\n", "t": "\t",
                        "r": "\r", "b": "\b", "f": "\f",
                    }.get(esc)
                    if mapped is None:
                        raise TOMLDecodeError(
                            f"line {ln}: unsupported escape \\{esc}"
                        )
                    out.append(mapped)
                    i += 2
                elif c == '"':
                    return "".join(out), s[i + 1:]
                else:
                    out.append(c)
                    i += 1
            raise TOMLDecodeError(f"line {ln}: unterminated string")
        if s[0] == "'":  # literal string: no escapes, ends at the next '
            end = s.find("'", 1)
            if end < 0:
                raise TOMLDecodeError(f"line {ln}: unterminated string")
            return s[1:end], s[end + 1:]
        if s[0] == "[":
            items = []
            rest = s[1:].strip()
            while True:
                if not rest:
                    raise TOMLDecodeError(f"line {ln}: unterminated array")
                if rest[0] == "]":
                    return items, rest[1:]
                v, rest = _parse_value(rest, ln)
                items.append(v)
                rest = rest.strip()
                if rest.startswith(","):
                    rest = rest[1:].strip()
                elif rest and rest[0] != "]":
                    raise TOMLDecodeError(
                        f"line {ln}: expected `,` or `]` in array"
                    )
        # bool / number token: runs to the next delimiter
        i = 0
        while i < len(s) and s[i] not in ",]#":
            i += 1
        token, rest = s[:i].strip(), s[i:]
        if token == "true":
            return True, rest
        if token == "false":
            return False, rest
        try:
            if any(c in token for c in ".eE") and not token.startswith("0x"):
                return float(token), rest
            return int(token, 0), rest
        except ValueError:
            raise TOMLDecodeError(f"line {ln}: bad value {token!r}") from None
