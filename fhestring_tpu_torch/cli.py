"""Command line: the oracle-differential harness.

Mirrors the reference binary (src/main.rs:34-116 + src/utils.rs:122-718 +
src/args.rs): takes --string/--pattern/--n/--from/--to, runs every supported
method variant homomorphically, compares each decrypted result against the
Python ``str`` oracle (standing in for Rust ``std``), and prints
``Test Passed/Failed`` plus the wall-clock per method.

    python -m fhestring_tpu_torch.cli --string "hello" --pattern "ello" \
        --n 1 --from "ello" --to "_llo" [--params test|test32|noisy|prod|turbo] \
        [--device cuda|cpu] [--methods ...] [--metrics]

The JAX package's ``cli.py`` on the port's ClientKey and ServerKey: same
arguments, same oracles, same printed lines.  ``--device`` says where the
server evaluates: ``cuda`` (the default; without a CUDA device the run stops
with a message, it never falls back to the CPU) or ``cpu`` (the plain
PyTorch versions of the kernels; small parameter sets only).
"""

from __future__ import annotations

import argparse
import time

from .client import ClientKey
from .params import (PARAM_PROD, PARAM_TEST32_ZERO_NOISE, PARAM_TEST_NOISY,
                     PARAM_TEST_ZERO_NOISE, PARAM_TURBO)

STRING_PADDING = 1  # reference src/main.rs:12

# The 52 runnable method variants (reference src/string_method.rs:2-55).
METHODS = [
    "Contains", "ContainsClear", "EndsWith", "EndsWithClear", "EqIgnoreCase",
    "Find", "FindClear", "IsEmpty", "Len", "Repeat", "RepeatClear",
    "Replace", "ReplaceClear", "ReplaceN", "ReplaceNClear", "Rfind",
    "RfindClear", "Rsplit", "RsplitClear", "RsplitOnce", "RsplitOnceClear",
    "RsplitN", "RsplitNClear", "RsplitTerminator", "RsplitTerminatorClear",
    "Split", "SplitClear", "SplitAsciiWhitespace", "SplitInclusive",
    "SplitInclusiveClear", "SplitTerminator", "SplitTerminatorClear",
    "SplitN", "SplitNClear", "StartsWith", "StartsWithClear", "StripPrefix",
    "StripPrefixClear", "StripSuffix", "StripSuffixClear", "ToLower",
    "ToUpper", "Trim", "TrimEnd", "TrimStart", "Concatenate", "Lt", "Le",
    "Gt", "Ge", "Eq", "Ne",
]


from .utils import trim_vector  # noqa: E402  (reference utils.rs:59-74)


def _py_rsplit(s, p):
    return [x for x in reversed(s.split(p))]


def _py_rsplitn(s, n, p):
    # Rust rsplitn: at most n pieces from the right, last piece is remainder.
    parts = s.split(p)
    if n <= 0:
        return []
    if len(parts) <= n:
        return list(reversed(parts))
    tail = parts[-(n - 1):] if n > 1 else []
    head = p.join(parts[: len(parts) - (n - 1)])
    return list(reversed(tail)) + [head] if n > 1 else [s]


def _py_splitn(s, n, p):
    if n <= 0:
        return []
    return s.split(p, n - 1)


def _py_split_inclusive(s, p):
    parts = s.split(p)
    out = [x + p for x in parts[:-1]]
    if parts[-1] != "":
        out.append(parts[-1])
    return out


def _py_split_terminator(s, p):
    parts = s.split(p)
    if parts and parts[-1] == "":
        parts.pop()
    return parts


def _py_rsplit_terminator(s, p):
    return list(reversed(_py_split_terminator(s, p)))


def compare_and_print(expected, actual) -> bool:
    ok = expected == actual
    if ok:
        print(f"Test Passed: OK, Result: {actual!r}, ", end="")
    else:
        print(f"Test Failed: Expected: {expected!r}, Got: {actual!r}, ", end="")
    return ok


def run_fhe_str_method(server, client, args, method: str) -> bool:
    """One method: encrypt -> homomorphic op -> decrypt -> oracle compare
    (reference utils.rs:122-718)."""
    s_plain, p_plain = args.string, args.pattern
    from_plain, to_plain, n_plain = args.frm, args.to, args.n

    s = client.encrypt(s_plain, STRING_PADDING)
    pattern = client.encrypt_no_padding(p_plain)
    frm = client.encrypt_no_padding(from_plain)
    to = client.encrypt_no_padding(to_plain)
    n = client.encrypt_char(n_plain % 256)
    pattern_padded = client.encrypt(p_plain, STRING_PADDING)

    find_expected = lambda r: 255 if r < 0 else r

    def split_case(fhe_split, expected_list):
        got, _found = client.decrypt_split(fhe_split)
        return compare_and_print(trim_vector(expected_list), trim_vector(got))

    m = method
    if m == "Contains":
        return compare_and_print(int(p_plain in s_plain),
                                 client.decrypt_char(server.contains(s, pattern)))
    if m == "ContainsClear":
        return compare_and_print(int(p_plain in s_plain),
                                 client.decrypt_char(server.contains_clear(s, p_plain)))
    if m == "EndsWith":
        return compare_and_print(int(s_plain.endswith(p_plain)),
                                 client.decrypt_char(server.ends_with(s, pattern)))
    if m == "EndsWithClear":
        return compare_and_print(int(s_plain.endswith(p_plain)),
                                 client.decrypt_char(server.ends_with_clear(s, p_plain)))
    if m == "EqIgnoreCase":
        return compare_and_print(int(s_plain.lower() == p_plain.lower()),
                                 client.decrypt_char(server.eq_ignore_case(s, pattern_padded)))
    if m == "Find":
        return compare_and_print(find_expected(s_plain.find(p_plain)),
                                 client.decrypt_char(server.find(s, pattern)))
    if m == "FindClear":
        return compare_and_print(find_expected(s_plain.find(p_plain)),
                                 client.decrypt_char(server.find_clear(s, p_plain)))
    if m == "IsEmpty":
        return compare_and_print(int(s_plain == ""),
                                 client.decrypt_char(server.is_empty(s)))
    if m == "Len":
        return compare_and_print(len(s_plain), client.decrypt_char(server.len(s)))
    if m == "Repeat":
        return compare_and_print(s_plain * n_plain,
                                 client.decrypt(server.repeat(s, n)))
    if m == "RepeatClear":
        return compare_and_print(s_plain * n_plain,
                                 client.decrypt(server.repeat_clear(s, n_plain)))
    if m == "Replace":
        return compare_and_print(s_plain.replace(from_plain, to_plain),
                                 client.decrypt(server.replace(s, frm, to)))
    if m == "ReplaceClear":
        return compare_and_print(s_plain.replace(from_plain, to_plain),
                                 client.decrypt(server.replace_clear(s, from_plain, to_plain)))
    if m == "ReplaceN":
        return compare_and_print(s_plain.replace(from_plain, to_plain, n_plain),
                                 client.decrypt(server.replacen(s, frm, to, n)))
    if m == "ReplaceNClear":
        return compare_and_print(
            s_plain.replace(from_plain, to_plain, n_plain),
            client.decrypt(server.replacen_clear(s, from_plain, to_plain, n_plain)))
    if m == "Rfind":
        return compare_and_print(find_expected(s_plain.rfind(p_plain)),
                                 client.decrypt_char(server.rfind(s, pattern)))
    if m == "RfindClear":
        return compare_and_print(find_expected(s_plain.rfind(p_plain)),
                                 client.decrypt_char(server.rfind_clear(s, p_plain)))
    if m == "Rsplit":
        return split_case(server.rsplit(s, pattern), _py_rsplit(s_plain, p_plain))
    if m == "RsplitClear":
        return split_case(server.rsplit_clear(s, p_plain), _py_rsplit(s_plain, p_plain))
    if m in ("RsplitOnce", "RsplitOnceClear"):
        fhe_split = (server.rsplit_once(s, pattern) if m == "RsplitOnce"
                     else server.rsplit_once_clear(s, p_plain))
        if p_plain in s_plain:
            before, _, after = s_plain.rpartition(p_plain)
            return split_case(fhe_split, [after, before])
        got, found = client.decrypt_split(fhe_split)
        return compare_and_print(0, found)
    if m == "RsplitN":
        return split_case(server.rsplitn(s, pattern, n),
                          _py_rsplitn(s_plain, n_plain, p_plain))
    if m == "RsplitNClear":
        return split_case(server.rsplitn_clear(s, p_plain, n_plain),
                          _py_rsplitn(s_plain, n_plain, p_plain))
    if m == "RsplitTerminator":
        return split_case(server.rsplit_terminator(s, pattern),
                          _py_rsplit_terminator(s_plain, p_plain))
    if m == "RsplitTerminatorClear":
        return split_case(server.rsplit_terminator_clear(s, p_plain),
                          _py_rsplit_terminator(s_plain, p_plain))
    if m == "Split":
        return split_case(server.split(s, pattern), s_plain.split(p_plain))
    if m == "SplitClear":
        return split_case(server.split_clear(s, p_plain), s_plain.split(p_plain))
    if m == "SplitAsciiWhitespace":
        return split_case(server.split_ascii_whitespace(s), s_plain.split())
    if m == "SplitInclusive":
        return split_case(server.split_inclusive(s, pattern),
                          _py_split_inclusive(s_plain, p_plain))
    if m == "SplitInclusiveClear":
        return split_case(server.split_inclusive_clear(s, p_plain),
                          _py_split_inclusive(s_plain, p_plain))
    if m == "SplitTerminator":
        return split_case(server.split_terminator(s, pattern),
                          _py_split_terminator(s_plain, p_plain))
    if m == "SplitTerminatorClear":
        return split_case(server.split_terminator_clear(s, p_plain),
                          _py_split_terminator(s_plain, p_plain))
    if m == "SplitN":
        return split_case(server.splitn(s, pattern, n),
                          _py_splitn(s_plain, n_plain, p_plain))
    if m == "SplitNClear":
        return split_case(server.splitn_clear(s, p_plain, n_plain),
                          _py_splitn(s_plain, n_plain, p_plain))
    if m == "StartsWith":
        return compare_and_print(int(s_plain.startswith(p_plain)),
                                 client.decrypt_char(server.starts_with(s, pattern)))
    if m == "StartsWithClear":
        return compare_and_print(int(s_plain.startswith(p_plain)),
                                 client.decrypt_char(server.starts_with_clear(s, p_plain)))
    if m in ("StripPrefix", "StripPrefixClear"):
        strip = (server.strip_prefix(s, pattern) if m == "StripPrefix"
                 else server.strip_prefix_clear(s, p_plain))
        got, found = client.decrypt_strip(strip)
        if s_plain.startswith(p_plain):
            return compare_and_print((s_plain[len(p_plain):], 1), (got, found))
        return compare_and_print(0, found)
    if m in ("StripSuffix", "StripSuffixClear"):
        strip = (server.strip_suffix(s, pattern) if m == "StripSuffix"
                 else server.strip_suffix_clear(s, p_plain))
        got, found = client.decrypt_strip(strip)
        if s_plain.endswith(p_plain) and p_plain:
            return compare_and_print((s_plain[: -len(p_plain)], 1), (got, found))
        if p_plain == "":
            return compare_and_print(1, found)
        return compare_and_print(0, found)
    if m == "ToLower":
        return compare_and_print(s_plain.lower(), client.decrypt(server.to_lower(s)))
    if m == "ToUpper":
        return compare_and_print(s_plain.upper(), client.decrypt(server.to_upper(s)))
    if m == "Trim":
        return compare_and_print(s_plain.strip(), client.decrypt(server.trim(s)))
    if m == "TrimEnd":
        return compare_and_print(s_plain.rstrip(), client.decrypt(server.trim_end(s)))
    if m == "TrimStart":
        return compare_and_print(s_plain.lstrip(), client.decrypt(server.trim_start(s)))
    if m == "Concatenate":
        return compare_and_print(s_plain + p_plain,
                                 client.decrypt(server.concatenate(s, pattern_padded)))
    if m in ("Lt", "Le", "Gt", "Ge", "Eq", "Ne"):
        import operator
        ops = {"Lt": operator.lt, "Le": operator.le, "Gt": operator.gt,
               "Ge": operator.ge, "Eq": operator.eq, "Ne": operator.ne}
        res = getattr(server, m.lower())(s, pattern_padded)
        return compare_and_print(int(ops[m](s_plain, p_plain)),
                                 client.decrypt_char(res))
    raise ValueError(f"unknown method {method}")


PARAM_SETS = {
    "test": PARAM_TEST_ZERO_NOISE,
    "test32": PARAM_TEST32_ZERO_NOISE,
    "noisy": PARAM_TEST_NOISY,
    "prod": PARAM_PROD,
    "turbo": PARAM_TURBO,
}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="fhestring",
        description="A FHE string implementation on PyTorch and CUDA")
    ap.add_argument("-s", "--string", required=True,
                    help="The string to do the processing on")
    ap.add_argument("-p", "--pattern", required=True,
                    help="The pattern for the algorithms that need it")
    ap.add_argument("-n", "--n", type=int, required=True,
                    help="The number of times to make an operation")
    ap.add_argument("-f", "--from", dest="frm", required=True,
                    help="What will be replaced (for replace algorithms)")
    ap.add_argument("-t", "--to", required=True,
                    help="What will replace it (for replace algorithms)")
    ap.add_argument("--params", choices=sorted(PARAM_SETS), default="test",
                    help="crypto parameter set (default: test)")
    ap.add_argument("--methods", nargs="*", default=None,
                    help="subset of methods to run (default: all 52)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics", action="store_true",
                    help="print per-method PBS counts (see metrics.py)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the server evaluates (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from .engine.strings import MAX_REPETITIONS

    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda (the default) needs a CUDA device and "
                 "torch.cuda.is_available() is false; pass --device cpu to "
                 "run the plain PyTorch path (small parameter sets only)")

    # reference src/main.rs:37-41
    assert args.n <= MAX_REPETITIONS, (
        "Repeat method will not function correctly, increase MAX_REPETITIONS "
        "(max = 255)")

    t0 = time.time()
    client = ClientKey(PARAM_SETS[args.params], seed=args.seed,
                       device=args.device)
    server = client.get_server_key()
    print(f"Keygen took {time.time() - t0:.1f}s")

    from . import metrics

    methods = args.methods if args.methods else METHODS
    failures = 0
    for method in methods:
        t0 = time.time()
        before = metrics.GLOBAL.snapshot()
        try:
            ok = run_fhe_str_method(server, client, args, method)
        except Exception as e:  # parity: reference panics abort the run
            print(f"Test Errored: {e!r}, ", end="")
            ok = False
        failures += 0 if ok else 1
        extra = ""
        if args.metrics:
            d = metrics.GLOBAL.delta(before)
            extra = f" [{d.pbs_items} PBS in {d.pbs_calls} batches]"
        print(f"{method} {time.time() - t0:.3f}s{extra}")
    print(f"\n{len(methods) - failures}/{len(methods)} methods passed")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
