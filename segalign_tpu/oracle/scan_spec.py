"""Sequential-scan specification of the x-drop extension.

The reference's warp/tile-32 algorithm (src/seed_filter.cu:302-604) is
semantically equivalent to a plain left-to-right scan; this module states
that scan form in NumPy. The equivalence (property-tested against
extend_hit_tile32 in tests/test_extension_oracle.py) is what lets the device
programs use 512/2048-wide windows while reproducing reference output
exactly:

  Walk positions p = 0, 1, 2, ...:
    cum_p   = cum_{p-1} + sub[ref[loc+p], query[loc+p]]   (0 when out of bounds)
    (m_p, pos_p) = (cum_p, p) if cum_p > m_{p-1} else (m_{p-1}, pos_{p-1})
    stop at the FIRST p with (m_p - cum_p) > xdrop; the result is
    (m_{p-1}, pos_{p-1}) — the running max strictly before the drop position.
    If no drop, stop at the sequence edge with (m, pos) over all in-bounds
    positions.

  The max is tie-broken to the EARLIEST position (strict > for improvement).
  Entropy counts: matches (equal codes < 4) at positions <= the final max
  position, in each direction (left scan counts positions 1..left_pos back
  from the anchor).
"""

from __future__ import annotations

import numpy as np


def _scan_direction(score_block, n: int, xdrop: int, block: int = 1024):
    """Scan the n per-position scores of one direction (index 0 = first
    extension position) and return (max_score, max_pos, stop_pos), where
    positions are 1-based counts of included positions: max_pos = number
    of positions in the maximal extent (0 = none).

    score_block(lo, hi) returns the scores of positions [lo, hi). They are
    read block by block up to the first drop, so a hit costs what its
    extension scans, not the rest of the sequence; the result is that of
    the whole-array scan:
      cum = cumsum(scores); m = max(cummax(cum), 0)
      stop = first p with m_p - cum_p > xdrop (n if none)
      (max_score, max_pos) = max and first argmax of cum[:stop], or
      (0, -1) when that max is <= 0 (or stop == 0).

    Internally positions here are 0-based; the caller maps to the
    reference's conventions (right: pos 0 = anchor; left: pos 1 = first
    char before anchor)."""
    c = 0            # running score before the block
    mx = 0           # running max of cum, floored at 0
    best, best_pos = None, -1
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        cum = c + np.cumsum(score_block(lo, hi))
        m = np.maximum(np.maximum.accumulate(cum), mx)
        drop = (m - cum) > xdrop
        d = int(np.argmax(drop)) if drop.any() else hi - lo
        if d > 0:
            j = int(np.argmax(cum[:d]))
            if best is None or cum[j] > best:
                best, best_pos = int(cum[j]), lo + j
        if d < hi - lo:
            stop = lo + d
            break
        c, mx = int(cum[-1]), int(m[-1])
    else:
        stop = n
    if stop == 0:
        return 0, -1, 0
    if best <= 0:
        return 0, -1, stop
    return best, best_pos, stop


def extend_hit_scan(ref: np.ndarray, query: np.ndarray, ref_loc: int,
                    query_loc: int, sub: np.ndarray, xdrop: int,
                    hspthresh: int, noentropy: bool):
    """Scan-form equivalent of oracle.reference.extend_hit_tile32."""
    ref_len = len(ref)
    query_len = len(query)

    # ---- right: positions p = 0.. map to (ref_loc+p, query_loc+p)
    lim_r = max(0, min(ref_len - ref_loc, query_len - query_loc))
    m_r, p_r, stop_r = _scan_direction(
        lambda lo, hi: sub[ref[ref_loc + lo:ref_loc + hi],
                           query[query_loc + lo:query_loc + hi]
                           ].astype(np.int64), lim_r, xdrop)
    # right extent in reference convention: max_pos (0-based position index),
    # -1 -> prev_max_pos initial value of -1 is reported as extent 0 in the
    # tile algorithm only via max_pos; replicate: extent = p_r if any else -1
    right_pos = p_r if p_r >= 0 else -1

    # ---- left: positions p = 1.. map to (ref_loc-p, query_loc-p)
    lim_l = max(0, min(ref_loc, query_loc))
    m_l, p_l, stop_l = _scan_direction(
        lambda lo, hi: sub[ref[ref_loc - hi:ref_loc - lo][::-1],
                           query[query_loc - hi:query_loc - lo][::-1]
                           ].astype(np.int64), lim_l, xdrop)
    left_pos = (p_l + 1) if p_l >= 0 else 0  # reference left positions are 1-based

    total = m_r + m_l
    extent = (right_pos if right_pos >= 0 else 0) + left_pos
    # NOTE: when right_pos == -1 the tile algorithm's extent contribution is
    # max_pos == -1, i.e. extent = left_pos - 1; replicate exactly:
    extent = right_pos + left_pos

    # ---- entropy counts: matches at in-extent positions
    counts = np.zeros(4, dtype=np.int64)
    if right_pos >= 0:
        rr = ref[ref_loc:ref_loc + right_pos + 1]
        qq = query[query_loc:query_loc + right_pos + 1]
        mask = (rr == qq) & (rr < 4)
        for c in range(4):
            counts[c] += int(np.sum(mask & (rr == c)))
    if left_pos > 0:
        rr = ref[ref_loc - left_pos:ref_loc]
        qq = query[query_loc - left_pos:query_loc]
        mask = (rr == qq) & (rr < 4)
        for c in range(4):
            counts[c] += int(np.sum(mask & (rr == c)))

    entropy = 1.0
    if hspthresh <= total <= 3 * hspthresh and not noentropy:
        if int(counts.sum()) >= 20:
            ext1 = float(extent + 1)
            e = 0.0
            for c in range(4):
                if counts[c] != 0:
                    e += (counts[c] / ext1) * np.log(counts[c] / ext1)
            entropy = -e / np.log(4.0)

    adjusted = int(np.float32(total) * entropy)
    if adjusted >= hspthresh:
        score = total
        if entropy > 0:
            score = int(total * entropy)
        return True, ref_loc - left_pos, query_loc - left_pos, extent, score
    return False, ref_loc, query_loc, 0, 0


def window_step(ref: np.ndarray, query: np.ndarray, loc_r: int, loc_q: int,
                tile: int, W: int, left: bool, cum: int, maxv: int,
                maxp: int, sub: np.ndarray, xdrop: int):
    """One W-position window of the scan for one live hit: the contract of
    the device window step (ops/extend3._extension_window_step_jit without
    entropy counts). Positions are p = tile .. tile+W-1 to the right of the
    anchor (0 = the anchor) or p = tile+1 .. tile+W to its left; positions
    off either sequence score 0. The running max carries in as
    (maxv, maxp). Returns (finished, cum, maxv, maxp) after the window,
    where cum is the score summed over the whole window."""
    p = tile + np.arange(W) + (1 if left else 0)
    if left:
        inb = (loc_r >= p) & (loc_q >= p)
        ri, qi = loc_r - p, loc_q - p
        edge = loc_r < tile + W or loc_q < tile + W
    else:
        inb = (loc_r + p < len(ref)) & (loc_q + p < len(query))
        ri, qi = loc_r + p, loc_q + p
        edge = (loc_r + tile + W - 1 >= len(ref)
                or loc_q + tile + W - 1 >= len(query))
    ri = np.where(inb, ri, 0)
    qi = np.where(inb, qi, 0)
    sc = np.where(inb, sub[ref[ri], query[qi]], 0).astype(np.int64)
    c = cum + np.cumsum(sc)
    m = np.maximum(maxv, np.maximum.accumulate(c))
    drop = (m - c) > xdrop
    d = int(np.argmax(drop)) if drop.any() else W
    if d > 0 and int(c[:d].max()) > maxv:
        maxv = int(c[:d].max())
        maxp = int(p[int(np.argmax(c[:d]))])
    return bool(drop.any() or edge), int(c[-1]), maxv, maxp
