"""On-device assignment: Jacobi auction LAP + online gap-aware tracker.

PyTorch counterpart of ``axtrack_tpu/track/lap_device.py``: a Bertsekas
auction solver for per-frame-pair assignment, with each detection's "open
a new track" option as a private virtual column, and an online tracker
that chains assignments with <= MCF_MAX_NUM_MISSES gap lanes. The exact
association path stays the host min-cost-flow (``track/tracker.py``).

Every array lives on the device of the inputs and every step is a torch
op. The JAX package runs each bidding loop as a ``lax.while_loop`` with no
host sync; here the loop body runs in chunks of 1, 2, 4, ... rounds, at
most ``CHECK_EVERY``, and the loop condition is read on the host once per
chunk (one sync). That leaves the result unchanged: once no row bids, a
round changes nothing (every column's top bid is -inf, so nothing is won
or kicked), and a chunk never runs past ``n_iters``. The chunks grow
because most auctions of the tracker end in one or two rounds, and a long
one still syncs only once every ``CHECK_EVERY`` rounds. ``STATS`` counts
the bidding rounds (rounds in which some row bid, summed on the device)
and the syncs.

Scatters that the JAX package writes with ``.at[...].set(mode='drop')``
write into one spare sink slot past the end, which is then cut off, so an
out-of-range index drops. ``torch.argmax`` takes the first maximum, as
``jnp.argmax`` does.
"""
import numpy as np
import torch

from . import costs as C

BIG = 1e9
# the most bidding rounds between two host reads of the loop condition
CHECK_EVERY = 16
# counters of the auctions since the last reset: 'rounds' (a device tensor
# until read) and 'syncs'
STATS = {'rounds': 0, 'syncs': 0}


def reset_stats():
    STATS['rounds'], STATS['syncs'] = 0, 0


def read_stats():
    """(bidding rounds, syncs) since the last reset."""
    return int(STATS['rounds']), STATS['syncs']


def _f32(v, dev):
    return torch.as_tensor(v, dtype=torch.float32, device=dev)


def _scatter_drop(target, idx, values):
    """``target.at[idx].set(values, mode='drop')`` for indices in [0,
    len(target)]: index len(target) is a spare slot, cut off after."""
    n = target.shape[0]
    out = torch.cat([target, target[:1]])
    out[idx.clamp(0, n)] = values
    return out[:n]


def _full(n, fill, like):
    return torch.full((n,), fill, dtype=like.dtype, device=like.device)


def auction_lap(cost, row_valid, col_valid, eps=1e-3, n_iters=4000,
                n_phases=6, scale=True):
    """Epsilon-optimal min-cost assignment via Jacobi auction with epsilon
    scaling (``axtrack_tpu``'s ``auction_lap``).

    cost: f32[N, M] (entries > BIG/2 forbidden); row_valid/col_valid: bool
    masks; ``scale=False`` runs one phase at ``eps`` from zero prices.
    Returns int64[N]: the column of each row, -1 unassigned.
    """
    dev = cost.device
    cost = cost.to(torch.float32)
    N, M = cost.shape
    eps_t = _f32(eps, dev)
    benefit = torch.where(col_valid[None, :] & (cost < BIG / 2), -cost,
                          _f32(-BIG, dev))                  # maximize
    finite = benefit > -BIG / 2
    inf = _f32(float('inf'), dev)
    spread = (torch.where(finite, benefit, -inf).max()
              - torch.where(finite, benefit, inf).min())
    spread = torch.where(torch.isfinite(spread), torch.maximum(spread, eps_t),
                         eps_t)
    feasible_row = finite.any(1)
    can_bid = row_valid & feasible_row
    rows = torch.arange(N, device=dev)
    cols = torch.arange(M, device=dev)
    if scale:
        phase_epss = torch.maximum(
            spread / 2 * (_f32(0.25, dev) ** torch.arange(
                n_phases, dtype=torch.float32, device=dev)), eps_t)
    else:
        phase_epss = eps_t.reshape(1)

    prices = torch.zeros(M, dtype=torch.float32, device=dev)
    for phase_eps in phase_epss:
        assign = torch.full((N,), -1, dtype=torch.int64, device=dev)
        owner = torch.full((M,), -1, dtype=torch.int64, device=dev)
        it, chunk = 0, 1
        while it < n_iters:
            for _ in range(min(chunk, n_iters - it)):
                assign, owner, prices, bidding = _bid_round(
                    benefit, prices, assign, owner, spread, phase_eps,
                    can_bid, rows, cols, inf)
                STATS['rounds'] = STATS['rounds'] + bidding.any()
            it += min(chunk, n_iters - it)
            chunk = min(2 * chunk, CHECK_EVERY)
            STATS['syncs'] += 1
            if not bool(((assign < 0) & can_bid).any()):
                break
    return assign


def _bid_round(benefit, prices, assign, owner, spread, phase_eps, can_bid,
               rows, cols, inf):
    """One Jacobi bidding round (the body of the JAX package's while
    loop)."""
    N = benefit.shape[0]
    value = benefit - prices[None, :]                      # [N, M]
    best_v = value.max(1).values
    best_j = value.argmax(1)              # first maximum, as jnp.argmax
    # second best for the bid increment
    second_v = value.index_put((rows, best_j), -inf).max(1).values
    # bound the bid when the runner-up is a forbidden sentinel
    floor = best_v - spread - phase_eps
    second_v = torch.where(second_v > -BIG / 2, second_v, floor)
    bid = best_v - second_v + phase_eps

    bidding = (assign < 0) & can_bid
    # each column takes the highest bid among bidders targeting it
    bid_for_col = torch.where(bidding[:, None]
                              & (best_j[:, None] == cols[None, :]),
                              bid[:, None], -inf)           # [N, M]
    top_bid = bid_for_col.max(0).values
    top_row = bid_for_col.argmax(0)
    won = torch.isfinite(top_bid)

    # previous owners of re-auctioned columns become unassigned
    prev_owner = torch.where(won & (owner >= 0), owner, N)
    kicked = _scatter_drop(_full(N, False, won), prev_owner, won.new_ones(
        prev_owner.shape))
    assign = torch.where(kicked, -1, assign)

    owner = torch.where(won, top_row, owner)
    prices = torch.where(won, prices + top_bid, prices)
    # winning rows get their column; non-won columns must not scatter
    safe_row = torch.where(won, top_row, N)
    new_assign_col = _scatter_drop(_full(N, -1, cols), safe_row, cols)
    assign = torch.where(new_assign_col >= 0, new_assign_col, assign)
    return assign, owner, prices, bidding


def auction_lap_fallback(cost, person_valid, obj_valid, fallback_cost,
                         eps=1e-3, n_iters=4000, n_phases=6):
    """Auction where every person has a private outside option
    (``axtrack_tpu``'s ``auction_lap_fallback``): each person's fallback is
    a virtual column feasible for that person only, solved in one phase
    from zero prices. cost: f32[P, O]; fallback_cost: f32[P]. Returns
    int64[P]: the object of each person, -1 = took the fallback."""
    dev = cost.device
    P, O = cost.shape
    fb = torch.as_tensor(fallback_cost, dtype=torch.float32, device=dev)
    virt = torch.full((P, P), BIG, dtype=torch.float32, device=dev)
    virt[torch.arange(P, device=dev), torch.arange(P, device=dev)] = fb
    cost_aug = torch.cat([cost.to(torch.float32), virt], 1)   # [P, O + P]
    col_valid = torch.cat([obj_valid, person_valid])
    a = auction_lap(cost_aug, person_valid, col_valid, eps=eps,
                    n_iters=n_iters, scale=False)
    return torch.where(a >= O, -1, a)


def track_scan(obs, valid, packed, off, cs, ct, max_gap, miss_rate,
               edge_thr, entry_exit_cost, max_px):
    """Whole-movie online tracking, frame by frame on the device
    (``axtrack_tpu``'s ``track_scan``, the body of its ``lax.scan``).

    obs: f32[T, D] observation costs (BIG for padding); valid: bool[T, D];
    packed: f32[Np], every real lookback distance matrix raveled and
    concatenated; off/cs/ct: int64[T, G], where packed[off[t, g-1]:...] is
    the row-major [cs, ct] = [counts[t-g], counts[t]] matrix of gap g into
    frame t (cs == 0: no matrix; reads fall back to max_px). Returns
    int64[T, D]: the trajectory id of each detection (-1 for padding), in
    discovery order.
    """
    dev = obs.device
    T, D = obs.shape
    G = int(max_gap)
    S = D * (G + 2)
    nolog = _f32(1e-6, dev)
    miss_rate, edge_thr, max_px = (_f32(v, dev) for v in
                                   (miss_rate, edge_thr, max_px))
    entry_exit_cost = _f32(entry_exit_cost, dev)
    big = _f32(BIG, dev)
    n_packed = packed.shape[0]
    cols = torch.arange(D, device=dev)
    slots = torch.arange(S, device=dev)

    last_frame = torch.full((S,), -(10 ** 6), dtype=torch.int64, device=dev)
    last_det = torch.zeros(S, dtype=torch.int64, device=dev)
    traj = torch.full((S,), -1, dtype=torch.int64, device=dev)
    next_id = torch.zeros((), dtype=torch.int64, device=dev)
    out = []
    for t in range(T):
        obs_t, valid_t = obs[t], valid[t]
        gap = t - last_frame                               # [S]
        active = (gap >= 1) & (gap <= G)
        g_idx = (gap - 1).clamp(0, G - 1)
        ld = last_det.clamp(0, D - 1)
        # per-slot distance row, gathered from the packed real matrices
        csg, ctg = cs[t][g_idx], ct[t][g_idx]              # [S]
        flat = (off[t][g_idx] + ld * ctg)[:, None] + cols[None, :]
        val = packed[flat.clamp(0, n_packed - 1)]
        in_mat = (ld[:, None] < csg[:, None]) & (cols[None, :]
                                                 < ctg[:, None])
        rowD = torch.where(in_mat, val, max_px)            # [S, D]
        closeness = 1.0 - rowD / max_px
        reachable = closeness > 0
        tc = -torch.log(closeness * (miss_rate ** (gap[:, None] - 1).to(
            torch.float32)) + nolog)
        row = tc + obs_t[None, :]
        ok = (reachable & (tc <= edge_thr) & active[:, None]
              & valid_t[None, :])
        row = torch.where(ok, row, big)
        new_cost = 2.0 * entry_exit_cost + obs_t
        row = torch.where(row >= new_cost[None, :], big, row)

        # detections bid for slots, each with its private "open a new
        # track" fallback
        det_slot = auction_lap_fallback(row.T, valid_t, active, new_cost)
        matched = (det_slot >= 0) & valid_t
        slot_det = _scatter_drop(_full(S, -1, cols),
                                 torch.where(matched, det_slot, S), cols)
        won = slot_det >= 0
        last_frame = torch.where(won, t, last_frame)
        last_det = torch.where(won, slot_det, last_det)

        # open new tracks on free slots for unmatched valid detections
        free = last_frame < (t - G)
        free_rank = free.cumsum(0) - 1
        pos_of_rank = _scatter_drop(_full(S, S, slots),
                                    torch.where(free, free_rank, S), slots)
        um = valid_t & ~matched
        um_rank = um.cumsum(0) - 1                         # [D]
        slot_j = torch.where(um, pos_of_rank[um_rank.clamp(0, S - 1)], S)
        last_frame = _scatter_drop(last_frame, slot_j,
                                   torch.full_like(slot_j, t))
        last_det = _scatter_drop(last_det, slot_j, cols)
        new_ids = next_id + um_rank
        traj = _scatter_drop(traj, slot_j, new_ids)
        next_id = next_id + um.sum()

        out.append(torch.where(matched, traj[det_slot.clamp(0, S - 1)],
                               torch.where(um, new_ids, -1)))
    return torch.stack(out) if out else torch.zeros(
        (0, D), dtype=torch.int64, device=dev)



class OnlineTracker:
    """Greedy online identity tracker on the device LAP
    (``axtrack_tpu``'s ``OnlineTracker``): frame by frame, active tracks
    (with gap lanes up to MCF_MAX_NUM_MISSES) compete for the new
    detections at the reference's transition costs, against each
    detection's "new track" price of entry + exit + observation cost.

    ``track`` runs the movie through ``track_scan``; ``track_host`` is the
    sequential per-frame loop it is held to. Both run on ``device``.
    """

    def __init__(self, params, device='cpu'):
        self.P = params
        self.max_px = 500
        self.device = torch.device(device)

    def track(self, frame_dets, astar_dists):
        """Same inputs/outputs as tracker.assign_identities (trajectories
        as lists of (frame, det_idx))."""
        P = self.P
        T = len(frame_dets)
        if T == 0:
            return []
        G = P['MCF_MAX_NUM_MISSES'] + 1
        obs_all, offsets, counts = C.observation_setup(frame_dets, P)
        D = 8
        while D < max(counts + [1]):
            D *= 2

        obs = np.full((T, D), BIG, np.float32)
        valid = np.zeros((T, D), bool)
        for t in range(T):
            obs[t, :counts[t]] = obs_all[offsets[t]:offsets[t + 1]]
            valid[t, :counts[t]] = True
        # the real distance matrices, packed: O(sum counts[s]*counts[t])
        off = np.zeros((T, G), np.int64)
        cs = np.zeros((T, G), np.int64)
        ct = np.zeros((T, G), np.int64)
        parts, pos = [], 0
        for t in range(T):
            for g in range(1, G + 1):
                s = t - g
                Dmat = astar_dists.get((t, g))
                if (s < 0 or Dmat is None or Dmat.size == 0
                        or Dmat.shape != (counts[s], counts[t])):
                    continue
                off[t, g - 1] = pos
                cs[t, g - 1] = counts[s]
                ct[t, g - 1] = counts[t]
                parts.append(np.asarray(Dmat, np.float32).ravel())
                pos += Dmat.size
        packed = (np.concatenate(parts) if parts
                  else np.full(1, self.max_px, np.float32))

        dev = self.device
        det_traj = track_scan(
            torch.from_numpy(obs).to(dev), torch.from_numpy(valid).to(dev),
            torch.from_numpy(packed).to(dev), torch.from_numpy(off).to(dev),
            torch.from_numpy(cs).to(dev), torch.from_numpy(ct).to(dev), G,
            P['MCF_MISS_RATE'], P['MCF_EDGE_COST_THR'],
            P['MCF_ENTRY_EXIT_COST'], self.max_px).cpu().numpy()

        n_traj = int(det_traj.max()) + 1 if det_traj.size else 0
        trajectories = [[] for _ in range(n_traj)]
        for t in range(T):
            for j in range(counts[t]):
                tid = int(det_traj[t, j])
                if tid >= 0:
                    trajectories[tid].append((t, j))
        return trajectories

    def track_host(self, frame_dets, astar_dists):
        """Sequential per-frame loop (one auction per frame), the parity
        oracle of ``track``."""
        P = self.P
        dev = self.device
        max_gap = P['MCF_MAX_NUM_MISSES'] + 1
        obs_all, offsets, _ = C.observation_setup(frame_dets, P)

        trajectories = []
        active = []           # (traj_idx, last_frame, last_det_idx)
        for t in range(len(frame_dets)):
            n_det = len(frame_dets[t]['conf'])
            obs_t = obs_all[offsets[t]:offsets[t] + n_det]
            new_cost = (P['MCF_ENTRY_EXIT_COST'] * 2 + obs_t)

            cands = [a for a in active if t - a[1] <= max_gap]
            if n_det and cands:
                rows = []
                for (traj_i, lf, ld) in cands:
                    gap = t - lf
                    D = astar_dists.get((t, gap))
                    if D is None or D.shape[1] != n_det:
                        rows.append(np.full(n_det, BIG))
                        continue
                    tc = C.transition_costs(D[ld:ld + 1], P['MCF_MISS_RATE'],
                                            gap, self.max_px)
                    row = tc[0] + obs_t
                    row = np.where(
                        np.isfinite(row)
                        & (tc[0] <= P['MCF_EDGE_COST_THR']), row, BIG)
                    rows.append(row)
                cost = np.stack(rows)                   # [n_tracks, n_det]
                cost = np.where(cost >= new_cost[None, :], BIG, cost)
                Nr, Mc = cost.shape
                pad_r = max(8 - Nr % 8, 0) if Nr % 8 else 0
                pad_c = max(8 - Mc % 8, 0) if Mc % 8 else 0
                # transposed fallback auction: detections bid for slots
                cost_p = np.pad(cost, ((0, pad_r), (0, pad_c)),
                                constant_values=BIG)
                pv = np.zeros(Mc + pad_c, bool)
                pv[:Mc] = True
                ov = np.zeros(Nr + pad_r, bool)
                ov[:Nr] = True
                fb = np.full(Mc + pad_c, BIG, np.float32)
                fb[:Mc] = new_cost
                det_slot = auction_lap_fallback(
                    torch.from_numpy(cost_p.T.astype(np.float32)).to(dev),
                    torch.from_numpy(pv).to(dev),
                    torch.from_numpy(ov).to(dev),
                    torch.from_numpy(fb).to(dev)).cpu().numpy()[:Mc]
            else:
                det_slot = np.full(n_det, -1, int)

            slot_det = {int(k): j for j, k in enumerate(det_slot)
                        if 0 <= k < len(cands)}
            taken = set()
            still_active = []
            for k, (traj_i, lf, ld) in enumerate(cands):
                j = slot_det.get(k, -1)
                if j >= 0 and j < n_det and j not in taken:
                    trajectories[traj_i].append((t, j))
                    still_active.append((traj_i, t, j))
                    taken.add(j)
                else:
                    still_active.append((traj_i, lf, ld))
            # non-candidates are too old for good (last_frame never rewinds)
            active = still_active

            # every unmatched detection opens a track
            for j in range(n_det):
                if j not in taken:
                    trajectories.append([(t, j)])
                    active.append((len(trajectories) - 1, t, j))
        return trajectories
