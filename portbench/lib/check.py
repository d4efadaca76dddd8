"""The comparison that decides ``correct``: the program's outputs from the
window against the plain reference (``portbench/reference/``), which
reads them only to judge them.

Inference cells (per distinct output of each movie, at most
``max_checked`` drawn from the seed):

- ``det_gap``: the widest gap between the program's detections and the
  reference's CNN, decode and NMS on the same movie (``reference.detect.
  judge``), in confidence units;
- ``dist_gap``: the largest difference between the program's association
  distances and the reference's breadth-first-search distances between the
  program's detections (integers: an exact comparison);
- ``id_gap``: how much costlier the program's identities are than the
  optimum of the tracking graph built on its detections and the
  reference's distances, relative to that optimum (999 where they are no
  flow of the graph).

Training cell (the first three steps of set-up's first epoch):

- ``loss_gap``: the relative difference of the first step's loss (the
  later steps' losses carry Adam's first update, about lr * sign(g),
  which flips with the sign of gradient entries at rounding level);
- ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient as Adam took it (from its first moment) and the reference's,
  over the larger of that leaf's reference norm and the median leaf's;
- ``change_gap``: the same for each leaf's change over the three steps,
  over the leaves whose reference gradient is not nought to rounding
  (at least a thousandth of the median leaf's; a conv bias before a
  BatchNorm has a zero gradient and moves by round-off alone).

Each limit lies between the readings of sound runs and of the control or
a planted fault; PERF.md gives the readings each was set from.
"""
import time

import numpy as np
import torch

from ..reference import detect as D
from ..reference import geodesic as G
from ..reference import mcf as MCF
from ..reference import model as M
from ..reference import train as RT
from . import config

LIMITS = {'det_gap': 2.5e-5, 'dist_gap': 0.0, 'id_gap': 1e-9,
          'loss_gap': 5e-7, 'grad_gap': 3e-3, 'change_gap': 1e-1}
INVALID = 999.0
STEPS = 3


def reference_net(ctx, sd=None):
    """The reference's detector of the configuration: the bundle's
    checkpoint read by its own orbax reader, or the seeded state dict."""
    P = config.params_json(ctx)
    if sd is not None:
        net = M.from_state_dict(sd, P)
    else:
        from ..reference import orbax
        tree = orbax.read_orbax(config.bundle_dir(ctx) + '/E0300')
        net = M.from_flax(tree, P)
        net = _to(net, ctx.device)
    return net, P


def _to(a, device):
    if isinstance(a, torch.Tensor):
        return a.to(device)
    if isinstance(a, dict):
        return {k: _to(v, device) for k, v in a.items()}
    if isinstance(a, list):
        return [_to(v, device) for v in a]
    return a


def reference_frames(ctx, net, P, mv, ops):
    """The reference's decisions for every centre frame of one movie."""
    frames = D.preprocess(mv['raw'], mv['mask'], config.scaler_var(ctx),
                          ctx.device, log_correct=P['LOG_CORRECT'])
    grids, tyx = D.grids(net, frames, P['TILESIZE'], P['TEMPORAL_CONTEXT'],
                         ops)
    del frames
    return [D.decide(D.cells(g, tyx, P['TILESIZE']),
                     P['NON_MAX_SUPRESSION_DIST']) for g in grids]


def dist_gap(prog, ref):
    gap = 0.0
    for key, r in ref.items():
        p = prog.get(key)
        if p is None:
            if r.size:
                return INVALID
            continue
        p = np.asarray(p)
        if p.shape != r.shape:
            return INVALID
        if r.size:
            gap = max(gap, float(np.max(np.abs(p.astype(np.float64) - r))))
    return gap


def trajectories(dets, ids):
    """The identities as lists of (frame, detection index), from the
    IDed_dets_all values [n_ids, T, (x, y, conf)]; None if an identity
    sits where no detection is."""
    if ids is None:
        return []
    out = []
    for row in ids[1]:
        tr = []
        for t, (x, y, _) in enumerate(row):
            if np.isnan(x):
                continue
            d = dets[t]
            hit = np.nonzero((d['anchor_x'] == x) & (d['anchor_y'] == y))[0]
            if len(hit) != 1:
                return None
            tr.append((t, int(hit[0])))
        out.append(tr)
    return out


def id_gap(dets, dists, ids, P):
    obs, offsets, trans = MCF.graph(dets, dists, P)
    best = MCF.optimum(obs, trans, P)
    tracks = trajectories(dets, ids)
    if best is None:
        return 0.0 if ids is None else INVALID
    if tracks is None or ids is None:
        return INVALID
    cost = MCF.trajectories_cost(tracks, obs, offsets, trans, P)
    if cost is None:
        return INVALID
    return max(0.0, (cost - best) / max(1.0, abs(best)))


class Clock:
    """Adds the seconds since its last call to ``notes[name]``."""

    def __init__(self, notes):
        self.notes, self.t = notes, time.perf_counter()

    def __call__(self, name):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.notes[name] = round(self.notes.get(name, 0.0) + now - self.t, 3)
        self.t = now


def kept_dets(frames):
    """The reference's detections of each frame as the program gives
    them (conf, anchor_x, anchor_y), from ``reference_frames``."""
    return [{'conf': r['conf'][r['kept']], 'anchor_x': r['x'][r['kept']],
             'anchor_y': r['y'][r['kept']]} for r in frames]


def faults(out, ref, mv, P, ctx, tile):
    """Readings of faults planted in a program output (for the limits'
    upper readings): a detection moved 3 px where it is produced; the
    detections of every other tile column left out (half the CNN's batch);
    one association distance off by one; one identity split in two."""
    import copy
    dets = copy.deepcopy(out['dets'])
    t = max(range(len(dets)), key=lambda k: len(dets[k]['conf']))
    dets[t]['anchor_x'][0] += 3
    moved = max(D.judge(p, r) for p, r in zip(dets, ref))
    half = [{k: v[(d['anchor_x'] // tile) % 2 == 0] for k, v in d.items()}
            for d in out['dets']]
    halved = max(D.judge(p, r) for p, r in zip(half, ref))
    out_f = {'fault_moved_det_gap': moved, 'fault_half_det_gap': halved}
    ref_d, _ = G.lookback(mv['mask'], out['dets'], P['MCF_MAX_NUM_MISSES'] + 1,
                          P['MCF_EDGE_COST_THR'], ctx.device)
    dists = {k: v.copy() for k, v in out['dists'].items()}
    near = [k for k, v in dists.items() if (v < G.MAX_DIST).any()]
    if near:
        i, j = np.argwhere(dists[near[0]] < G.MAX_DIST)[0]
        dists[near[0]][i, j] += 1
        out_f['fault_dist_gap'] = dist_gap(dists, ref_d)
    ids = out['ids']
    if ids is not None and len(ids[0]):
        longest = int(np.argmax((~np.isnan(ids[1][..., 0])).sum(1)))
        row = ids[1][longest]
        present = np.nonzero(~np.isnan(row[:, 0]))[0]
        if len(present) > 1:
            cut = present[len(present) // 2]
            a, b = row.copy(), row.copy()
            a[cut:], b[:cut] = np.nan, np.nan
            split = (ids[0] + ['split'], np.concatenate(
                [np.delete(ids[1], longest, 0), a[None], b[None]]))
            out_f['fault_split_id_gap'] = id_gap(out['dets'], ref_d, split,
                                                 P)
    return out_f


def infer(st, ctx, rec, max_checked, control=False):
    """(numbers, notes) of an inference cell's window. With ``control``
    the notes also hold the control's reading: the reference at TF32 put
    in the program's place (its detections judged as the program's)."""
    M.exact()
    net, P = reference_net(ctx, st.get('weights'))
    rng = np.random.default_rng(ctx.seed)
    nums = {'det_gap': 0.0, 'dist_gap': 0.0, 'id_gap': 0.0}
    works, notes = {}, {'outputs': 0}
    by_movie = {}
    for (i, _), out in st.get('outputs', {}).items():
        by_movie.setdefault(i, []).append(out)
    for i, outs in sorted(by_movie.items()):
        if len(outs) > max_checked:
            outs = [outs[k] for k in sorted(rng.choice(
                len(outs), max_checked, replace=False))]
        mv = st['movies'][i]
        clock = Clock(notes)
        with torch.no_grad():
            ref = reference_frames(ctx, net, P, mv, M.Ops())
        clock('t_detect')
        for out in outs:
            notes['outputs'] += 1
            nums['det_gap'] = max(nums['det_gap'], max(
                D.judge(p, r) for p, r in zip(out['dets'], ref)))
            clock('t_judge')
            dists, work = G.lookback(mv['mask'], out['dets'],
                                     P['MCF_MAX_NUM_MISSES'] + 1,
                                     P['MCF_EDGE_COST_THR'], ctx.device)
            works.setdefault(i, work)
            nums['dist_gap'] = max(nums['dist_gap'],
                                   dist_gap(out['dists'], dists))
            clock('t_dist')
            nums['id_gap'] = max(nums['id_gap'], id_gap(
                out['dets'], dists, out['ids'], P))
            clock('t_mcf')
        notes[f'dets_movie{i}'] = int(sum(len(d['conf'])
                                          for d in outs[0]['dets']))
        if control:
            with torch.no_grad():
                low = kept_dets(reference_frames(ctx, net, P, mv,
                                                 M.Ops('tf32')))
            readings = {'control_det_gap': max(
                D.judge(p, r) for p, r in zip(low, ref))}
            readings.update(faults(outs[0], ref, mv, P, ctx, P['TILESIZE']))
            for k, v in readings.items():
                notes[k] = max(notes.get(k, 0.0), v)
        del ref
    rec['k1_work'] = works
    return nums, notes


def leaf_gaps(prog, ref, keys):
    """Each leaf's |norm_prog - norm_ref| over max(norm_ref, median
    reference norm), by name."""
    rn = {k: float(ref[k].double().norm()) for k in keys}
    med = float(np.median(list(rn.values())))
    return {k: abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med)
            for k in keys}


def train_gaps(prog, ref):
    """The three numbers of ``prog`` (a run's first steps) against
    ``ref`` (the reference's), and the leaves left out of the change."""
    keys = list(ref['grad'])
    rg = {k: float(ref['grad'][k].double().norm()) for k in keys}
    moving = [k for k in keys
              if rg[k] >= 1e-3 * float(np.median(list(rg.values())))]
    losses = [abs(p - r) / abs(r) for p, r in zip(prog['losses'],
                                                  ref['losses'])]
    grad = leaf_gaps(prog['grad'], ref['grad'], keys)
    change = leaf_gaps(prog['change'], ref['change'], moving)
    worst = lambda g: max(g, key=g.get)  # noqa: E731
    return {'loss_gap': losses[0], 'grad_gap': grad[worst(grad)],
            'change_gap': change[worst(change)]}, {
                'step_loss_gaps': losses, 'still': len(keys) - len(moving),
                'grad_worst': worst(grad), 'change_worst': worst(change),
                'grad_median_gap': float(np.median(list(grad.values()))),
                'change_median_gap': float(np.median(list(change.values())))}


def train(st, ctx, control=False):
    """(numbers, notes) of the training cell's first steps. With
    ``control`` the notes also hold the readings of the control (the
    reference at TF32 in the program's place) and of a fault planted in
    the reference: half of each batch left out, the loss the mean over
    the rest."""
    M.exact()
    P = st['ref_P']
    data = RT.epoch_data(st['movie']['raw'], st['movie']['mask'],
                         st['labels'], P, ctx.seed, ctx.device)
    weights = _to(st['weights'], ctx.device)
    ref = RT.steps(weights, P, data, STEPS)
    nums, more = train_gaps(st['first_steps'], ref)
    notes = dict(more, transform=data['cfg'],
                 program_transform=st['first_steps'].get('transform'))
    if control:
        notes['control'] = train_gaps(
            RT.steps(weights, P, data, STEPS, M.Ops('tf32')), ref)
        notes['half_batch'] = train_gaps(
            RT.steps(weights, P, data, STEPS, half=True), ref)
    return nums, notes
