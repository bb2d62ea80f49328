"""The string VM: every reference method, vectorized and data-oblivious.

Re-implements the full algorithm surface of the reference's
src/server_key/{mod.rs,split.rs,trim.rs} (SURVEY.md section 2.2) over the
swappable backend, replacing the reference's scalar per-position loops with
batched tensor ops feeding wide PBS batches:

- position loops  -> window gathers + all/any reductions
- select chains   -> last/first-match one-hots + weighted one-hot sums
- bubble_zeroes_right (O(n^2) cmux, reference utils.rs:28-46)
                  -> rank-and-route oblivious stable compaction
- latch flags     -> prefix/suffix OR scans

Semantics (padding rules, 255 not-found sentinel, fixed split buffer grids,
replacen counters, overlap masks — including the reference's quirks) match
the reference exactly, but for the forward split's overlap mask, which
follows Rust's ``str`` where the reference does not (``_split_scan``);
every method cites its reference lines.

Engine values are raw backend tensors; the typed API lives in server.py.
"""

from __future__ import annotations

import numpy as np

MAX_FIND_LENGTH = 255  # reference src/main.rs:20
MAX_REPETITIONS = 16   # reference src/main.rs:14-17


class StringEngine:
    def __init__(self, backend):
        self.b = backend

    # ------------------------------------------------------------------
    # small helpers
    # ------------------------------------------------------------------
    def _windows(self, s, count: int, m: int):
        """Gather all windows s[i:i+m] for i in [0, count) -> CT [count, m]."""
        idx = np.arange(count)[:, None] + np.arange(m)[None, :]
        return self.b.take(s, idx, axis=0)

    def _first_onehot(self, bits, axis=0):
        b = self.b
        seen = b.cum_or(bits, axis=axis, exclusive=True)
        return b.and_(bits, b.not_(seen))

    def _last_onehot(self, bits, axis=0):
        b = self.b
        seen = b.cum_or(bits, axis=axis, reverse=True, exclusive=True)
        return b.and_(bits, b.not_(seen))

    def _position_value(self, onehot, weights, default: int):
        """Encrypted value = weights[i] where onehot_i == 1, else default."""
        b = self.b
        miss = b.not_(b.any_axis(onehot, 0))
        ext = b.concat([onehot, b.reshape_bits(miss, (1,))], axis=0)
        w = np.concatenate([np.asarray(weights, np.uint8), [default]])
        return b.weighted_onehot_sum(ext, w, axis=0)

    def _bit_to_char(self, bit):
        """Promote an encrypted bit to a full u8 char value (0/1) — the
        reference returns predicates as FheAsciiChar radix values."""
        return self.b.mul_bit(self.b.trivial_chars(np.uint8(1)), bit)

    def compact_zeros_right(self, s, axis=-1):
        """Stable move of all NUL chars to the right: value-identical to the
        reference's bubble_zeroes_right (utils.rs:28-46).

        Butterfly (log-shift) routing, O(L log^2 L) PBS instead of the
        O(L^2) one-hot scatter grid of rounds 1-4: each nonzero element's
        final displacement is its exclusive prefix count of NULs; route all
        elements LSB-first through ceil(log2 L) left-shift stages, moving an
        element by 2^k at stage k iff bit k of its displacement is set. The
        routing is collision-free: displacements are non-decreasing and grow
        by at most (j - i - 1) between nonzeros i < j, so live positions
        i - (off_i mod 2^{k+1}) stay strictly increasing at every stage.
        Per stage the update is new = (cur - cur*m) + shift(cur*m): one
        mul_bit batch plus pure torus add/sub (zero PBS), with the
        not-yet-consumed displacement bits routed alongside as payload.

        Operates along the LAST axis and batches over any leading dims, so
        split post-passes compact all (len+1) buffers in one PBS batch."""
        b = self.b
        shape = tuple(b.shape(s))
        assert axis in (-1, len(shape) - 1)
        L = shape[-1]
        batch = shape[:-1]
        ax = len(batch)
        if L <= 1:
            return s
        nz = b.ne_zero(s)                            # [.., L]
        # Exclusive NUL-count == inclusive count at nonzero slots (their own
        # NUL bit is 0); NUL slots get garbage offsets, harmless because
        # their value AND payload bits are masked to 0 below, so they never
        # move and never collide with a routed live element.
        off = b.cumsum_bits(b.not_(nz), ax)          # [.., L] chars
        nbits = max(1, (L - 1).bit_length())
        # All displacement bits extracted in ONE PBS batch and masked to the
        # live elements in one more; `pay` keeps the not-yet-consumed bits
        # stacked on a leading axis so each stage routes them in ONE batch
        # (latency: warm per-method wall time is batch-COUNT-bound).
        pay = b.and_(b.char_bits(off, nbits), nz)    # [nbits, .., L]
        cur = s
        for k in range(nbits):
            sh = 1 << k
            if sh >= L:
                break
            m = b.take(pay, 0, axis=0)               # bit k, [.., L]
            moved = b.mul_bit(cur, m)                # 0 where m == 0
            stay = b.sub_exact(cur, moved)           # cur * (1 - m), no PBS
            arrived = b.concat([b.take(moved, np.arange(sh, L), axis=ax),
                                b.zeros_chars(batch + (sh,))], axis=ax)
            cur = b.add_nooverlap(stay, arrived)
            if k + 1 < nbits:                        # route remaining bits
                rest = b.take(pay, np.arange(1, nbits - k), axis=0)
                mb = b.and_(rest, m)                 # one batch for all
                stayb = b.sub_exact_bits(rest, mb)
                arrb = b.concat(
                    [b.take(mb, np.arange(sh, L), axis=ax + 1),
                     b.trivial_bits(np.zeros((nbits - k - 1,) + batch
                                             + (sh,), np.uint64))],
                    axis=ax + 1)
                pay = b.add_nooverlap_bits(stayb, arrb)
        return cur

    # ------------------------------------------------------------------
    # predicates (reference src/server_key/mod.rs)
    # ------------------------------------------------------------------
    def contains(self, s, pat):
        """mod.rs:151-182."""
        b = self.b
        L, m = b.shape(s)[0], b.shape(pat)[0]
        if L == 0 and m == 0:
            return b.trivial_bits(1)
        if m > L:
            return b.trivial_bits(0)
        W = L - m + 1
        if m == 0:
            return b.trivial_bits(1)
        wins = self._windows(s, W, m)                # [W, m]
        eqs = b.eq(wins, b.reshape(pat, (1, m)))     # [W, m]
        match = b.all_axis(eqs, 1)                   # [W]
        return b.any_axis(match, 0)

    def ends_with(self, s, pat):
        """mod.rs:241-281: last all-non-NUL window wins."""
        b = self.b
        L, m = b.shape(s)[0], b.shape(pat)[0]
        if L == 0 and m == 0:
            return b.trivial_bits(1)
        if m > L:
            return b.trivial_bits(0)
        W = L - m + 1
        wins = self._windows(s, W, m)
        if m == 0:
            cur = b.trivial_bits(np.ones(W, np.uint8))
            valid = b.trivial_bits(np.ones(W, np.uint8))
        else:
            eqs = b.eq(wins, b.reshape(pat, (1, m)))
            cur = b.all_axis(eqs, 1)
            valid = b.all_axis(b.ne_zero(wins), 1)
        onehot = self._last_onehot(valid, 0)
        return b.any_axis(b.and_(cur, onehot), 0)

    def starts_with(self, s, pat):
        """mod.rs:344-369."""
        b = self.b
        L, m = b.shape(s)[0], b.shape(pat)[0]
        if m > L:
            return b.trivial_bits(0)
        if L == 0:
            return b.trivial_bits(1 if m == 0 else 0)
        end = min(m, L)
        if end == 0:
            return b.trivial_bits(1)
        eqs = b.eq(self.b.take(s, np.arange(end), axis=0),
                   b.take(pat, np.arange(end), axis=0))
        return b.all_axis(eqs, 0)

    def is_empty(self, s):
        """mod.rs:431-451."""
        b = self.b
        if b.shape(s)[0] == 0:
            return b.trivial_bits(1)
        return b.all_axis(b.eq_zero(s), 0)

    def len(self, s):
        """mod.rs:478-493: encrypted count of non-NUL chars."""
        b = self.b
        if b.shape(s)[0] == 0:
            return b.trivial_chars(np.uint8(0))
        return b.sum_bits(b.ne_zero(s), 0)

    # ------------------------------------------------------------------
    # search (find / rfind), mod.rs:727-790, 1010-1053
    # ------------------------------------------------------------------
    def find(self, s, pat):
        b = self.b
        L, m = b.shape(s)[0], b.shape(pat)[0]
        if L == 0 and m == 0:
            return b.trivial_chars(np.uint8(0))
        if L >= MAX_FIND_LENGTH + m:
            raise ValueError("Maximum supported size for find reached")
        if m > L:
            return b.trivial_chars(np.uint8(255))
        W = L - m + 1
        if m == 0:
            match = b.trivial_bits(np.ones(W, np.uint8))
        else:
            wins = self._windows(s, W, m)
            match = b.all_axis(b.eq(wins, b.reshape(pat, (1, m))), 1)
        onehot = self._first_onehot(match, 0)
        return self._position_value(onehot, np.arange(W), MAX_FIND_LENGTH)

    def rfind(self, s, pat):
        b = self.b
        zero = b.trivial_chars(np.zeros(1, np.uint8))
        s = b.concat([s, zero], axis=0)  # "quick fix" push, mod.rs:737
        L, m = b.shape(s)[0], b.shape(pat)[0]
        if L >= MAX_FIND_LENGTH + m:
            raise ValueError("Maximum supported size for find reached")
        if m == 0:
            # last non-NUL position + 1 (mod.rs:747-760)
            nz = b.ne_zero(s)
            onehot = self._last_onehot(nz, 0)
            return self._position_value(onehot, np.arange(1, L + 1), 0)
        if m > L:
            return b.trivial_chars(np.uint8(255))
        W = max(L - m, 1)  # adjust_end_of_pattern, exclusive (mod.rs:768-771)
        wins = self._windows(s, W, m)
        match = b.all_axis(b.eq(wins, b.reshape(pat, (1, m))), 1)
        onehot = self._last_onehot(match, 0)
        return self._position_value(onehot, np.arange(W), MAX_FIND_LENGTH)

    # ------------------------------------------------------------------
    # whole-string equality & ordering, mod.rs:1122-1231, 1470-1692
    # ------------------------------------------------------------------
    def eq_strings(self, s, t):
        b = self.b
        L1, L2 = b.shape(s)[0], b.shape(t)[0]
        ml = min(L1, L2)
        len_ne = self.b.ne(self.len(s), self.len(t))
        if ml == 0:
            is_eq = b.trivial_bits(1)
        else:
            ss = b.take(s, np.arange(ml), axis=0)
            tt = b.take(t, np.arange(ml), axis=0)
            chars_eq = b.eq(ss, tt)
            both_zero = b.and_(b.eq_zero(ss), b.eq_zero(tt))
            is_eq = b.all_axis(b.or_(both_zero, chars_eq), 0)
        return b.and_(b.not_(len_ne), is_eq)

    def ne_strings(self, s, t):
        return self.b.not_(self.eq_strings(s, t))

    def eq_ignore_case(self, s, t):
        return self.eq_strings(self.to_lower(s), self.to_lower(t))

    def compare(self, s, t, op: str):
        """Lexicographic-ish comparison, mod.rs:1470-1541 semantics:
        first differing position decides; all-equal prefixes fall back to a
        length comparison."""
        b = self.b
        zero = b.trivial_chars(np.zeros(1, np.uint8))
        if min(b.shape(s)[0], b.shape(t)[0]) == 0:
            s = b.concat([s, zero], axis=0)
            t = b.concat([t, zero], axis=0)
        ml = min(b.shape(s)[0], b.shape(t)[0])
        ss = b.take(s, np.arange(ml), axis=0)
        tt = b.take(t, np.arange(ml), axis=0)
        cmp_fn = {"lt": b.lt, "le": b.le, "gt": b.gt, "ge": b.ge}[op]
        cmp_bits = cmp_fn(ss, tt)
        diff = b.ne(ss, tt)
        onehot = self._first_onehot(diff, 0)
        decided = b.any_axis(b.and_(onehot, cmp_bits), 0)
        any_diff = b.any_axis(diff, 0)
        len1, len2 = self.len(s), self.len(t)
        length_based = {
            "ge": b.or_(b.eq(len1, len2), b.gt(len1, len2)),
            "le": b.or_(b.eq(len1, len2), b.lt(len1, len2)),
            "gt": b.gt(len1, len2),
            "lt": b.lt(len1, len2),
        }[op]
        # any_diff ? decided : length_based   (bits)
        return b.or_(b.and_(any_diff, decided),
                     b.and_(b.not_(any_diff), length_based))

    # ------------------------------------------------------------------
    # rewriting, mod.rs:65-128, 517-591, 1864-1875; trim.rs
    # ------------------------------------------------------------------
    def to_upper(self, s):
        return self.b.to_upper(s) if self.b.shape(s)[0] else s

    def to_lower(self, s):
        return self.b.to_lower(s) if self.b.shape(s)[0] else s

    def concatenate(self, s, t):
        return self.compact_zeros_right(self.b.concat([s, t], axis=0))

    def repeat_clear(self, s, n: int):
        b = self.b
        if n == 0:
            return b.trivial_chars(np.zeros(0, np.uint8))
        return self.compact_zeros_right(b.concat([s] * n, axis=0))

    def repeat(self, s, n_enc):
        """mod.rs:567-591: MAX_REPETITIONS slots gated by i < n."""
        b = self.b
        L = b.shape(s)[0]
        slots = np.arange(MAX_REPETITIONS, dtype=np.uint8)
        flags = b.lt(b.trivial_chars(slots), n_enc)  # broadcasts () -> [16]
        grid = b.broadcast_to(b.reshape(s, (1, L)), (MAX_REPETITIONS, L))
        gated = b.mul_bit(grid, b.reshape_bits(flags, (MAX_REPETITIONS, 1)))
        flat = b.reshape(gated, (MAX_REPETITIONS * L,))
        return self.compact_zeros_right(flat)

    def trim_end(self, s):
        """trim.rs:36-57: suffix latch — keep chars from the last
        non-whitespace non-NUL onward."""
        b = self.b
        keep = b.and_(b.not_(b.is_whitespace(s)), b.ne_zero(s))
        stop = b.cum_or(keep, 0, reverse=True)
        return b.mul_bit(s, stop)

    def trim_start(self, s):
        """trim.rs:86-115 (prefix latch + compaction)."""
        b = self.b
        keep = b.and_(b.not_(b.is_whitespace(s)), b.ne_zero(s))
        stop = b.cum_or(keep, 0)
        return self.compact_zeros_right(b.mul_bit(s, stop))

    def trim(self, s):
        return self.trim_start(self.trim_end(s))

    # ------------------------------------------------------------------
    # strip_prefix / strip_suffix, mod.rs:1261-1396
    # ------------------------------------------------------------------
    def strip_prefix(self, s, pat):
        b = self.b
        L, m = b.shape(s)[0], b.shape(pat)[0]
        if m > L:
            return s, b.trivial_bits(0)
        if min(m, L) == 0:
            flag = b.trivial_bits(1 if m == 0 else 0)  # mod.rs:1279-1289
        else:
            flag = b.all_axis(
                b.eq(b.take(s, np.arange(m), axis=0), pat), 0)
        if m > 0:
            head = b.take(s, np.arange(m), axis=0)
            head = b.mul_bit(head, b.not_(flag))
            s = b.concat([head, b.take(s, np.arange(m, L), axis=0)], axis=0)
        return self.compact_zeros_right(s), flag

    def strip_suffix(self, s, pat):
        b = self.b
        L, m = b.shape(s)[0], b.shape(pat)[0]
        if m > L:
            return s, b.trivial_bits(0)
        W = L - m + 1
        wins = self._windows(s, W, m)
        if m == 0:
            found = b.trivial_bits(np.ones(W, np.uint8))
            valid = b.trivial_bits(np.ones(W, np.uint8))
        else:
            found = b.all_axis(b.eq(wins, b.reshape(pat, (1, m))), 1)
            valid = b.all_axis(b.ne_zero(wins), 1)
        last_valid = self._last_onehot(valid, 0)
        c = b.and_(last_valid, found)  # one-hot of the stripped window
        should = b.any_axis(c, 0)
        if m > 0:
            # zero out the window where c fires (mod.rs:1380-1390)
            mask_cols = []
            for p in range(L):
                lo = max(0, p - m + 1)
                hi = min(W - 1, p)
                if lo > hi:
                    mask_cols.append(None)
                else:
                    idx = np.arange(lo, hi + 1)
                    mask_cols.append(b.any_axis(b.take(c, idx, axis=0), 0))
            keep_bits = [b.not_(mc) if mc is not None else b.trivial_bits(1)
                         for mc in mask_cols]
            keep = b.stack(keep_bits, axis=0)
            s = b.mul_bit(s, keep)
        return s, should

    # ------------------------------------------------------------------
    # replace / replacen, mod.rs:624-697, 828-980, 1729-1830
    # ------------------------------------------------------------------
    def replace(self, s, frm, to, n_enc=None):
        """Dispatch on public pattern lengths (mod.rs:632-652)."""
        m_from = self.b.shape(frm)[0]
        m_to = self.b.shape(to)[0]
        if m_from >= m_to:
            return self._handle_longer_from(s, frm, to, n_enc)
        return self._handle_shorter_from(s, frm, to, n_enc)

    def _handle_longer_from(self, s, frm, to, n_enc):
        """from.len >= to.len (mod.rs:828-882): match on the ORIGINAL buffer,
        overwrite windows with zero-padded `to`, compact."""
        b = self.b
        zero = b.trivial_chars(np.zeros(1, np.uint8))
        s = b.concat([s, zero], axis=0)  # push, mod.rs:841
        L = b.shape(s)[0]
        f, t = b.shape(frm)[0], b.shape(to)[0]
        to_padded = b.concat([to, b.trivial_chars(np.zeros(f - t, np.uint8))],
                             axis=0) if f > t else to
        result = s
        if f <= L:
            W = max(L - f, 1)  # adjust_end_of_pattern, exclusive (mod.rs:856-859)
            if f == 0:
                flags = b.trivial_bits(np.ones(W, np.uint8))
            else:
                wins = self._windows(s, W, f)
                flags = b.all_axis(b.eq(wins, b.reshape(frm, (1, f))), 1)
            if n_enc is not None:
                counters = b.cumsum_bits(flags, 0)          # inclusive
                keep = b.ge(n_enc, counters)                # n >= counter
                flags = b.and_(flags, keep)
            # sequential writes result[i+k] = flag_i ? to[k] : ..., i ascending.
            # per output position the LAST firing i wins; resolve per diagonal
            # d = k descending (equals ascending i for fixed position).
            for d in range(f - 1, -1, -1):
                # positions p = i + d for i in [0, W): a CONTIGUOUS range
                # [d, min(d + W, L)) — the update is one three-part splice
                # (O(1) graph nodes per diagonal), not a per-position
                # rebuild (the round-3 version concatenated L parts per
                # diagonal: O(f*L) graph nodes per replace).
                hi = min(d + W, L)
                if hi <= d:
                    continue
                idx = np.arange(hi - d)
                flag_sel = b.take(flags, idx, axis=0)
                to_d = b.take(to_padded, np.full(hi - d, d), axis=0)
                cur = b.take(result, idx + d, axis=0)
                new = b.select(flag_sel, to_d, cur)
                parts = []
                if d > 0:
                    parts.append(b.take(result, np.arange(d), axis=0))
                parts.append(new)
                if hi < L:
                    parts.append(b.take(result, np.arange(hi, L), axis=0))
                result = b.concat(parts, axis=0)
        return self.compact_zeros_right(result)

    def _handle_shorter_from(self, s, frm, to, n_enc):
        """from.len < to.len (mod.rs:885-980): inherently sequential —
        matches test the mutated buffer; each step shifts the tail by the
        size difference through a snapshot. Runs as ONE backend scan (a
        single compiled lax.scan on the FHE backend) over the output
        positions instead of per-position unrolled graphs."""
        b = self.b
        zero1 = b.trivial_chars(np.zeros(1, np.uint8))
        s = b.concat([s, zero1], axis=0)  # push, mod.rs:898
        L = b.shape(s)[0]
        f, t = b.shape(frm)[0], b.shape(to)[0]
        size_diff = t - f
        max_out = t * L + L if f > 0 else (L + (L + 1) * t) + 1  # mod.rs:903-914
        n_steps = max_out - t
        result = b.concat(
            [s, b.trivial_chars(np.zeros(max_out - L, np.uint8))], axis=0)
        ignore = b.trivial_bits(np.ones(max_out, np.uint8))
        counter = b.trivial_chars(np.uint8(0))
        positions = np.arange(max_out)

        # Fixed scan-carry noise/degree budget (values ops actually produce:
        # select -> 2.0, and_/mul_bit/add_chars -> 1.0 fresh-PBS units).
        result = b.declare(result, 3, 2.0)
        ignore = b.declare_bits(ignore, 1, 1.0)
        counter = b.declare(counter, 3, 1.0)

        xs = {"i": np.arange(n_steps, dtype=np.int32)}
        if f == 0:
            xs["flag0"] = (np.arange(n_steps) % (t + 1) == 0).astype(np.uint8)

        def body(carry, x):
            result, ignore, counter = carry
            i = x["i"]
            if f == 0:
                flag = b.trivial_bits_dyn(x["flag0"])
                flag = b.declare_bits(flag, 1, 1.0)
            else:
                win = b.dynamic_slice(result, i, f)
                eqs = b.eq(win, frm)
                masked = b.and_(eqs, b.dynamic_slice_bits(ignore, i, f))
                flag = b.all_axis(masked, 0)
            if n_enc is not None:
                counter = b.add_chars(counter, self._bit_to_char(flag))
                flag = b.and_(flag, b.ge(n_enc, counter))
            # snapshot gated by flag (mod.rs:957-959)
            snapshot = b.mul_bit(result, flag)
            # candidate buffer if the flag fires: `to` written at [i, i+t),
            # tail shifted right by size_diff from the snapshot
            # (mod.rs:962-977); prefix < i is unchanged by construction.
            with_to = b.dynamic_update_slice(result, to, i)
            shifted = b.concat(
                [b.trivial_chars(np.zeros(size_diff, np.uint8)),
                 b.take(snapshot, positions[:max_out - size_diff], axis=0)],
                axis=0)
            cand = b.select_pmask(positions >= i + t, shifted, with_to)
            result = b.select(flag, cand, result)
            # ignore mask update over [i, i+t) (mod.rs:965-968)
            not_flag = b.not_(flag)
            ig_win = b.and_(b.dynamic_slice_bits(ignore, i, t),
                            b.reshape_bits(not_flag, (1,)))
            ignore = b.dynamic_update_slice_bits(ignore, ig_win, i)
            return (b.declare(result, 3, 2.0),
                    b.declare_bits(ignore, 1, 1.0),
                    b.declare(counter, 3, 1.0))

        result, _, _ = b.scan(body, (result, ignore, counter), xs, n_steps)
        return result  # no compaction (mod.rs:979)

    # ------------------------------------------------------------------
    # split family, src/server_key/split.rs
    # ------------------------------------------------------------------
    def _split(self, s, pat, is_inclusive: bool, is_terminator: bool, n_enc,
               skip_first_edge: bool = False):
        """split.rs:883-988 (forward scan; windows END at i)."""
        b = self.b
        zero = b.trivial_chars(np.zeros(1, np.uint8))
        s = b.concat([s, zero], axis=0)  # push, split.rs:897
        L = b.shape(s)[0]
        m = b.shape(pat)[0]

        ccb = b.trivial_chars(np.uint8(0))  # current copy buffer
        if skip_first_edge and m == 0 and n_enc is not None:
            # splitn empty-pattern skip-first-buffer (split.rs:925-938)
            enc_len = self.len(s)
            should_skip = b.and_(b.gt(n_enc, b.trivial_chars(np.uint8(1))),
                                 b.le(n_enc, enc_len))
            ccb = self._bit_to_char(should_skip)
        allow = None
        if n_enc is not None:
            allow = b.ne(n_enc, b.trivial_chars(np.uint8(0)))  # split.rs:916-919

        grid, global_found = self._split_scan(
            s, pat, ccb, allow, n_enc, reverse=False)
        buffers = self._clear_pattern_from_result(grid, pat, n_enc,
                                                  is_inclusive, is_terminator)
        return buffers, global_found

    def _split_scan(self, s, pat, ccb, allow, n_enc, reverse: bool,
                    found_pre=None):
        """Shared scan core of _split/_rsplit (split.rs:70-178, 10-68): one
        backend scan over positions carrying (ccb, stop_inc, ignore,
        global_found) — O(L) state.

        The reference's copy_logic scatters char i into buffer ccb_i inside
        the loop (split.rs:108-135).  That column depends only on the O(1)
        counter ccb_i, so the scan EMITS ccb_i per step (scan_out ys) and
        the whole L x L grid is built afterwards as one batched
        eq + mul_bit — value-identical, same PBS count, but the scan carry
        stays O(L) (this is what makes the multi-chip dryrun compile:
        round 2 carried the full encrypted grid through every step).

        Window geometry: a match found at step i occupies the window that
        ENDS at i, [i-m+1, i] (forward scan), or STARTS at i, [i, i+m)
        (reverse scan, found only when i+m < L, the reference's literal
        bound, which no match inside the string reaches).  Each step reads
        the ignore mask and writes it over that same window, so a window
        that overlaps an earlier match is skipped and an adjacent one is
        not: Rust's leftmost non-overlapping matches forward (``split``,
        ``split_terminator``, ``split_inclusive``, ``splitn``) and its
        rightmost ones, searched from the end, in reverse (``rsplit`` and
        its kin).  The reference crate's forward scan, and the JAX
        package's, write the mask over [i, i+m) instead, which blocks the
        next adjacent match and admits an overlapping one where the pattern
        overlaps itself (``" bb bb      "`` split at ``"  "``); the port
        follows Rust there on purpose.  The mask's positions are public, so
        the bootstraps are the same either way.
        """
        b = self.b
        L = b.shape(s)[0]
        m = b.shape(pat)[0]
        positions = np.arange(L)

        stop_inc = b.trivial_bits(0)
        ignore = b.trivial_bits(np.ones(L, np.uint8))
        global_found = b.trivial_bits(0)
        buffer_ids = b.trivial_chars(np.arange(L, dtype=np.uint8))

        order = np.arange(L - 1, -1, -1) if reverse else np.arange(L)
        start = order if reverse else order - m + 1   # the match's window
        valid = (m > 0) and (m <= L)
        valid_i = valid & ((order + m < L) if reverse else (start >= 0))
        # equal to start wherever a match can be found; clamped elsewhere,
        # where the step's write leaves the mask as it is
        win_start = np.clip(start, 0, max(L - m, 0))
        xs = {"i": order.astype(np.int32),
              "valid": valid_i.astype(np.uint8),
              "win_start": win_start.astype(np.int32)}

        ccb = b.declare(ccb, 3, 1.0)
        stop_inc = b.declare_bits(stop_inc, 1, 1.0)
        ignore = b.declare_bits(ignore, 1, 1.0)
        global_found = b.declare_bits(global_found, 1, 1.0)

        def body(carry, x):
            ccb, stop_inc, ignore, global_found = carry
            i = x["i"]
            # copy_logic reads the PRE-update counter (split.rs:108-135):
            # char i lands in buffer ccb_i — emitted as this step's y.
            y = ccb

            # pattern matching gated by the public validity of the window
            if found_pre is not None:
                found = b.dynamic_slice_bits(found_pre, i, 1)
                found = b.reshape_bits(found, ())
                found = b.declare_bits(found, 1, 1.0)
            elif m == 0 or m > L:
                found = b.declare_bits(b.trivial_bits(0), 1, 1.0)
            else:
                ws = x["win_start"]
                win = b.dynamic_slice(s, ws, m)
                eqs = b.eq(win, pat)
                masked = b.and_(eqs, b.dynamic_slice_bits(ignore, ws, m))
                found = b.all_axis(masked, 0)
                vbit = b.trivial_bits_dyn(x["valid"])
                found = b.and_(found, b.declare_bits(vbit, 1, 1.0))

            # ignore-mask write over the match's window
            if m > 0 and m <= L:
                not_found = b.not_(found)
                upd = b.and_(ignore, b.reshape_bits(not_found, (1,)))  # [L]
                ws = x["win_start"]
                wmask = (positions >= ws) & (positions < ws + m)
                ignore = b.select_pmask_bits(wmask, upd, ignore)
            global_found = b.or_(global_found, found)

            # handle_n_case (split.rs:137-178)
            if n_enc is None:
                ccb = b.add_chars(ccb, self._bit_to_char(found))
            else:
                n_minus1 = b.sub_chars(n_enc, b.trivial_chars(np.uint8(1)))
                stop_inc = b.or_(stop_inc, b.eq(ccb, n_minus1))
                inc = b.and_(found, b.not_(stop_inc))
                ccb = b.add_chars(ccb, self._bit_to_char(inc))

            return (b.declare(ccb, 3, 1.0),
                    b.declare_bits(stop_inc, 1, 1.0),
                    b.declare_bits(ignore, 1, 1.0),
                    b.declare_bits(global_found, 1, 1.0)), y

        carry = (ccb, stop_inc, ignore, global_found)
        carry, ccb_seq = b.scan_out(body, carry, xs, L)
        global_found = carry[3]

        # post-scan grid build (one batch): grid[c, p] = s_p * (c == ccb_p)
        ccb_pos = b.take(ccb_seq, np.argsort(order), axis=0)   # scan -> pos
        onehot = b.eq(b.reshape(buffer_ids, (L, 1)),
                      b.reshape(ccb_pos, (1, L)))              # [buf, pos]
        if allow is not None:
            onehot = b.and_(onehot, allow)
        sv = b.broadcast_to(b.reshape(s, (1, L)), (L, L))
        grid = b.declare(b.mul_bit(sv, onehot), 3, 1.0)
        return grid, global_found

    def _rsplit(self, s, pat, is_inclusive: bool, is_terminator: bool, n_enc):
        """split.rs:307-393 (reverse scan; windows START at i; empty-pattern
        padding special case, split.rs:10-68)."""
        b = self.b
        zero = b.trivial_chars(np.zeros(1, np.uint8))
        s = b.concat([s, zero], axis=0)
        L = b.shape(s)[0]
        m = b.shape(pat)[0]

        ccb = b.trivial_chars(np.uint8(0))
        allow = None
        if n_enc is not None:
            allow = b.ne(n_enc, b.trivial_chars(np.uint8(0)))

        found_pre = None
        if m == 0:
            # rsplit empty-pattern padding matcher (split.rs:10-40),
            # vectorized over all positions (no ignore/ccb dependence):
            # found_i = (prev_nonzero & cur_pad) | !cur_pad, prev_nonzero
            # taken as 0 at i == 0.
            cur_pad = b.eq_zero(s)                                # [L]
            nz = b.ne_zero(s)
            prev_nz = b.concat(
                [b.trivial_bits(np.zeros(1, np.uint8)),
                 b.take(nz, np.arange(L - 1), axis=0)], axis=0)   # [L]
            found_pre = b.or_(b.and_(prev_nz, cur_pad), b.not_(cur_pad))

        grid, global_found = self._split_scan(
            s, pat, ccb, allow, n_enc, reverse=True, found_pre=found_pre)
        buffers = self._clear_pattern_from_result(grid, pat, n_enc,
                                                  is_inclusive, is_terminator)
        return buffers, global_found

    def _delete_pattern_rows(self, rows, pat):
        """Batched per-row delimiter deletion: value-identical to calling
        replace(row, pat, NULs) + truncate per row (_handle_longer_from with
        an all-NUL `to`: every matched window is zeroed, then compacted),
        but one PBS batch over ALL rows at once."""
        b = self.b
        R, L = b.shape(rows)
        m = b.shape(pat)[0]
        # push trailing NUL column (mod.rs:841)
        rows2 = b.concat(
            [rows, b.trivial_chars(np.zeros((R, 1), np.uint8))], axis=1)
        Lr = L + 1
        if 0 < m <= Lr:
            W = max(Lr - m, 1)  # adjust_end_of_pattern (mod.rs:856-859)
            widx = np.arange(W)[:, None] + np.arange(m)[None, :]
            wins = b.take(rows2, widx, axis=1)               # [R, W, m]
            flags = b.all_axis(
                b.eq(wins, b.reshape(pat, (1, 1, m))), 2)    # [R, W]
            # cover[p] = any flag_i with i <= p < i+m  (all writes are NUL,
            # so "last write wins" degenerates to any-covering-match)
            cidx = np.arange(Lr)[:, None] - np.arange(m)[None, :]
            valid = (cidx >= 0) & (cidx < W)
            cover_w = b.take(flags, np.clip(cidx, 0, W - 1), axis=1)
            cover_w = b.mul_pmask_bits(cover_w, valid[None])  # [R, Lr, m]
            cover = b.any_axis(cover_w, 2)
            rows2 = b.mul_bit(rows2, b.not_(cover))
        out = self.compact_zeros_right(rows2)
        return b.take(out, np.arange(L), axis=1)             # truncate

    def _clear_pattern_from_result(self, grid, pat, n_enc, is_inclusive,
                                   is_terminator):
        """split.rs:180-305: delete delimiters from each buffer and compact.
        All (len+1) buffers processed as ONE batch (the reference loops rows
        sequentially, split.rs:976-977 calls it the slowest part)."""
        b = self.b
        nb, Lg = b.shape(grid)
        m = b.shape(pat)[0]

        if n_enc is not None:
            # stop latch per row j: stop_j = any_{k<=j} (n_enc == k+1)
            ids = b.trivial_chars((np.arange(1, nb + 1) % 256).astype(np.uint8))
            stop = b.cum_or(b.eq(ids, n_enc), 0)             # [nb]
            current = self.compact_zeros_right(grid)
            replaced = self._delete_pattern_rows(current, pat)
            return b.select(b.reshape_bits(stop, (nb, 1)), current, replaced)

        if not is_inclusive:
            rows = self._delete_pattern_rows(grid, pat)
        else:
            rows = self.compact_zeros_right(grid)
        if is_terminator:
            # split.rs:271-302, reproduced literally (including its
            # no-op-for-nonempty-pattern behavior). Latch over rows scanned
            # backwards == reverse-exclusive OR-scan of row-nonzero flags.
            is_zero = b.all_axis(b.eq_zero(rows), 1)         # [nb]
            if m == 0:
                starts = b.trivial_bits(np.ones(nb, np.uint8))
            elif m > Lg:
                starts = b.trivial_bits(np.zeros(nb, np.uint8))
            else:
                head = b.take(rows, np.arange(m), axis=1)    # [nb, m]
                starts = b.all_axis(b.eq(head, b.reshape(pat, (1, m))), 1)
            nzf = b.cum_or(b.not_(is_zero), 0, reverse=True, exclusive=True)
            should_delete = b.and_(b.and_(starts, is_zero), b.not_(nzf))
            rows = b.mul_bit(rows, b.reshape_bits(b.not_(should_delete),
                                                  (nb, 1)))
        return rows

    def split_ascii_whitespace(self, s):
        """split.rs:1377-1447: word-boundary state machine."""
        b = self.b
        L = b.shape(s)[0]
        if L == 0:
            return b.reshape(b.trivial_chars(np.zeros(0, np.uint8)), (0, 0)), \
                b.trivial_bits(0)
        ws = b.is_whitespace(s)  # [L], vectorized
        not_ws = b.not_(ws)
        global_found = b.any_axis(ws, 0)
        buffer_ids = b.trivial_chars(np.arange(L, dtype=np.uint8))

        ccb = b.declare(b.trivial_chars(np.uint8(0)), 3, 1.0)
        # prev_ws starts as trivial 1 (word-start latch), later carries the
        # PBS output of is_whitespace.
        prev_ws = b.declare_bits(b.trivial_bits(1), 1, 1.0)
        ws = b.declare_bits(ws, 1, 1.0)
        not_ws = b.declare_bits(not_ws, 1, 1.0)

        def body(carry, x):
            # O(1) carry; the scan emits the POST-update counter per step
            # (split.rs:1377-1447 copies char i into the buffer selected
            # after the word-boundary increment) and the grid is built
            # afterwards as one batch — see _split_scan.
            ccb, prev_ws = carry
            i = x["i"]
            ws_i = b.reshape_bits(b.dynamic_slice_bits(ws, i, 1), ())
            should_inc = b.and_(ws_i, b.not_(prev_ws))
            ccb = b.declare(
                b.add_chars(ccb, self._bit_to_char(should_inc)), 3, 1.0)
            return (ccb, b.declare_bits(ws_i, 1, 1.0)), ccb

        xs = {"i": np.arange(L, dtype=np.int32)}
        _, ccb_seq = b.scan_out(body, (ccb, prev_ws), xs, L)

        # grid[c, p] = s_p * (c == ccb_p) * not_ws_p, one batch
        onehot = b.eq(b.reshape(buffer_ids, (L, 1)),
                      b.reshape(ccb_seq, (1, L)))            # [buf, pos]
        copy_flag = b.and_(onehot, b.reshape_bits(not_ws, (1, L)))
        sv = b.broadcast_to(b.reshape(s, (1, L)), (L, L))
        grid = b.declare(b.mul_bit(sv, copy_flag), 3, 1.0)
        rows = self.compact_zeros_right(grid, axis=-1)  # batched over rows
        return rows, global_found
