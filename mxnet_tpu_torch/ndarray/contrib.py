"""Bounding-box and SSD ops (counterpart of the detection family in
``mxnet_tpu/ndarray/contrib.py``: ``box_iou``, ``box_nms``, ``ROIAlign``,
``MultiBoxPrior``, ``MultiBoxTarget`` and ``MultiBoxDetection``).

Each is a plain function on tensors that runs through the op funnel
(``ops/registry.py``) under the JAX package's name (``"box_iou"``,
``"box_nms"``, ``"ROIAlign"``, ``"MultiBoxPrior"``, ``"MultiBoxTarget"``,
``"MultiBoxDetection_decode"``), so ``amp`` and ``analysis/`` see them.
No kernel of the library stands behind them (none of the JAX package's
Pallas kernels does): they are PyTorch ops, fixed in shape and free of
host syncs, so that ``MultiBoxTarget`` runs inside a captured training
step and ``MultiBoxDetection``'s greedy suppression inside a captured
eval.

Where the JAX functions leave a choice to XLA, the port fixes it:

- ties: sorts are stable (``jnp.argsort`` is), and ``argmax`` takes the
  first maximum in both packages;
- duplicate best anchors: when two valid ground-truth boxes share their
  best anchor, the JAX scatter keeps the later one (XLA applies the
  updates in order on the CPU); the port takes the largest
  ground-truth index by ``scatter_reduce("amax")``, the same answer on
  the CPU and, deterministically, on a card (``index_put_`` with
  duplicate indices is undefined there);
- anchors: computed in float32 tensors, as ``jnp`` computes them, and
  float32 whatever the feature map's dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..ops.registry import invoke

__all__ = ["box_iou", "box_nms", "ROIAlign", "MultiBoxPrior",
           "MultiBoxTarget", "MultiBoxDetection"]

_SSD_VAR = (0.1, 0.1, 0.2, 0.2)


def _corner_iou(a, b):
    """IoU between (..., N, 4) and (..., M, 4) corner boxes -> (..., N, M)."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (br - tl).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * \
        (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * \
        (b[..., 3] - b[..., 1]).clamp(min=0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=1e-12)


def _to_corner(x, fmt):
    if fmt == "corner":
        return x
    # center: (cx, cy, w, h) -> (x1, y1, x2, y2)
    half = x[..., 2:] / 2
    return torch.cat([x[..., :2] - half, x[..., :2] + half], -1)


def _to_center(x):
    # corner (x1, y1, x2, y2) -> (cx, cy, w, h)
    wh = x[..., 2:] - x[..., :2]
    return torch.cat([x[..., :2] + wh / 2, wh], -1)


def box_iou(lhs, rhs, format="corner"):
    """Pairwise IoU of (..., N, 4) and (..., M, 4) boxes, corner
    ``(x1, y1, x2, y2)`` or center ``(cx, cy, w, h)``."""
    def fn(a, b):
        return _corner_iou(_to_corner(a, format), _to_corner(b, format))
    return invoke("box_iou", fn, lhs, rhs)


def _take_rows(x, order):
    """``x`` (B, N, ...) with its rows in ``order`` (B, N)."""
    idx = order.reshape(order.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(order.shape + x.shape[2:]))


def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Greedy non-maximum suppression of rows ``[id, score, x1, y1, x2,
    y2, ...]`` in (B, N, K) or (N, K): the rows come back sorted by
    score, suppressed and invalid rows set to -1 in every entry.

    The suppression mask of every ordered pair is computed once; the
    greedy walk then takes a few elementwise ops a rank (N of them, a
    Python loop over a static count), with no host sync, so a capture
    replays it as one graph."""
    def fn(x):
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
        b, n, _ = x.shape
        scores = x[..., score_index]
        ids = x[..., id_index] if id_index >= 0 else \
            torch.zeros_like(scores)
        boxes = _to_corner(x[..., coord_start:coord_start + 4], in_format)
        valid = scores > valid_thresh
        key = torch.where(valid, scores, torch.full_like(scores,
                                                         -float("inf")))
        order = torch.argsort(-key, dim=1, stable=True)
        rank = torch.arange(n, device=x.device)
        svalid = torch.gather(valid, 1, order)
        if topk > 0:
            svalid = svalid & (rank < topk)[None, :]
        sboxes = _take_rows(boxes, order)
        sids = torch.gather(ids, 1, order)
        iou = _corner_iou(sboxes, sboxes)                   # (b, n, n)
        # sup[b, i, j]: rank i, if kept, suppresses rank j
        sup = (iou > overlap_thresh) & svalid[:, :, None] & \
            (rank[None, :] > rank[:, None])[None]
        if not force_suppress:
            sup = sup & (sids[:, :, None] == sids[:, None, :])
        keep = torch.ones((b, n), dtype=torch.bool, device=x.device)
        for i in range(n):
            keep = keep & ~(sup[:, i] & keep[:, i, None])
        keep = keep & svalid
        sx = _take_rows(x, order)
        if in_format != out_format:
            coords = sx[..., coord_start:coord_start + 4]
            coords = _to_corner(coords, in_format) \
                if out_format == "corner" else _to_center(coords)
            sx = torch.cat([sx[..., :coord_start], coords,
                            sx[..., coord_start + 4:]], -1)
        out = torch.where(keep[..., None], sx, -torch.ones_like(sx))
        return out[0] if squeeze else out

    return invoke("box_nms", fn, data)


def ROIAlign(data, rois, pooled_size, spatial_scale, sample_ratio=2,
             position_sensitive=False):
    """ROI Align with bilinear sampling, Mask R-CNN's meaning: no
    rounding of the coordinates, samples past ``[-1, size]`` read 0, a
    negative batch index gives an all-zero ROI.

    data (N, C, H, W); rois (R, 5) ``[batch_idx, x1, y1, x2, y2]`` in
    image coordinates. Plain: out (R, C, PH, PW). ``position_sensitive``:
    the channels are grouped by output bin (C must divide by PH * PW) and
    out is (R, C / (PH * PW), PH, PW).

    ``sample_ratio <= 0`` samples the static bound ceil(H / PH) x
    ceil(W / PW) points a bin (the JAX package's meaning: the reference's
    per-ROI count is not a static shape)."""
    ph, pw = (pooled_size, pooled_size) if isinstance(pooled_size, int) \
        else tuple(pooled_size)

    def fn(x, r):
        n, c, h, w = x.shape
        if sample_ratio > 0:
            sry = srx = int(sample_ratio)
        else:
            sry = max(1, -(-h // ph))
            srx = max(1, -(-w // pw))
        if position_sensitive and c % (ph * pw):
            raise MXNetError(f"position_sensitive needs channels ({c}) "
                             f"divisible by PH*PW ({ph * pw})")
        nr = r.shape[0]
        dt, dev = r.dtype, r.device
        bi = r[:, 0].to(torch.int32)
        x1, y1, x2, y2 = [r[:, i + 1] * spatial_scale for i in range(4)]
        rw = torch.clamp(x2 - x1, min=1.0)
        rh = torch.clamp(y2 - y1, min=1.0)
        bin_w, bin_h = rw / pw, rh / ph

        def grid(lo, step, bins, sr):
            # lo + (bin + (sample + 0.5) / sr) * step, (R, bins * sr)
            cell = torch.arange(bins, device=dev, dtype=dt)[:, None] + \
                (torch.arange(sr, device=dev, dtype=dt)[None, :] + 0.5) / sr
            return (lo[:, None, None] + cell[None] * step[:, None, None]) \
                .reshape(nr, bins * sr)

        gy, gx = grid(y1, bin_h, ph, sry), grid(x1, bin_w, pw, srx)
        img = x[bi.clamp(0, n - 1).long()]                  # (R, c, h, w)
        in_y = (gy >= -1.0) & (gy <= h)
        in_x = (gx >= -1.0) & (gx <= w)
        cy = gy.clamp(0, h - 1)
        cx = gx.clamp(0, w - 1)
        y0 = torch.floor(cy)
        x0 = torch.floor(cx)
        y1i = (y0 + 1).clamp(0, h - 1).long()
        x1i = (x0 + 1).clamp(0, w - 1).long()
        y0i, x0i = y0.long(), x0.long()
        wy = cy - y0
        wx = cx - x0
        py, px = gy.shape[1], gx.shape[1]

        def rows(yi):                                       # (R, c, py, w)
            return torch.gather(img, 2, yi[:, None, :, None].expand(
                nr, c, py, w))

        def cols(t, xi):                                    # (R, c, py, px)
            return torch.gather(t, 3, xi[:, None, None, :].expand(
                nr, c, py, px))

        r0, r1 = rows(y0i), rows(y1i)
        wx_ = wx[:, None, None, :]
        top = cols(r0, x0i) * (1 - wx_) + cols(r0, x1i) * wx_
        bot = cols(r1, x0i) * (1 - wx_) + cols(r1, x1i) * wx_
        val = top * (1 - wy)[:, None, :, None] + bot * wy[:, None, :, None]
        val = val * (in_y[:, :, None] & in_x[:, None, :])[:, None]
        val = torch.where((bi >= 0)[:, None, None, None], val,
                          torch.zeros_like(val))            # padded ROI
        val = val.reshape(nr, c, ph, sry, pw, srx).mean((3, 5))
        if position_sensitive:
            cg = c // (ph * pw)
            # channel block (i, j) feeds output bin (i, j)
            val = val.reshape(nr, ph, pw, cg, ph, pw)
            # the diagonals over the two ph axes, then the two pw axes:
            # (R, pw, cg, pw, ph), then (R, cg, ph, pw)
            val = torch.diagonal(val, dim1=1, dim2=4)
            val = torch.diagonal(val, dim1=1, dim2=3)
        return val

    return invoke("ROIAlign", fn, data, rois)


def _as_tuple(v):
    return tuple(float(s) for s in (v if isinstance(v, (list, tuple))
                                    else (v,)))


def _anchor_shapes(sizes, ratios):
    """The anchors' half widths and half heights, every size at
    ratios[0] and then ratios[1:] at sizes[0]: float32 values (as Python
    floats) made by the float32 operations ``jnp`` makes them with
    (``s * sqrt(r)``, ``s / sqrt(r)``, then halved), on the host, so that
    the device needs no copy of them."""
    f = np.float32
    root = [np.sqrt(f(r)) for r in ratios]
    shapes = [(f(s), root[0]) for s in sizes] + \
        [(f(sizes[0]), r) for r in root[1:]]
    return [(float(s * r / f(2)), float(s / r / f(2))) for s, r in shapes]


def MultiBoxPrior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                  steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes of one feature map: data (B, C, H, W) -> (1, H * W *
    A, 4) float32 corner boxes in [0, 1], A = len(sizes) + len(ratios)
    - 1 (every size at ratios[0], then ratios[1:] at sizes[0])."""
    halves = _anchor_shapes(_as_tuple(sizes), _as_tuple(ratios))

    def fn(x):
        h, w = x.shape[2], x.shape[3]
        f32 = dict(dtype=torch.float32, device=x.device)
        step_y = steps[0] if steps[0] > 0 else 1.0 / h
        step_x = steps[1] if steps[1] > 0 else 1.0 / w
        cy = (torch.arange(h, **f32) + offsets[0]) * step_y
        cx = (torch.arange(w, **f32) + offsets[1]) * step_x
        cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")    # (H, W)
        boxes = torch.stack([torch.stack(
            [cxg - hw, cyg - hh, cxg + hw, cyg + hh], -1)
            for hw, hh in halves], -2)                      # (H, W, A, 4)
        if clip:
            boxes = boxes.clamp(0.0, 1.0)
        return boxes.reshape(1, -1, 4)

    return invoke("MultiBoxPrior", fn, data)


def _anchor_centres(anc):
    aw = (anc[:, 2] - anc[:, 0]).clamp(min=1e-12)
    ah = (anc[:, 3] - anc[:, 1]).clamp(min=1e-12)
    return aw, ah, (anc[:, 0] + anc[:, 2]) / 2, (anc[:, 1] + anc[:, 3]) / 2


def MultiBoxTarget(anchor, label, cls_pred, overlap_threshold=0.5,
                   ignore_label=-1.0, negative_mining_ratio=-1.0,
                   negative_mining_thresh=0.5, minimum_negative_samples=0,
                   variances=_SSD_VAR):
    """Match ground truth to anchors: anchor (1, N, 4); label (B, M, 5)
    rows ``[cls, x1, y1, x2, y2]`` (cls < 0: padding); cls_pred (B,
    classes + 1, N), read only by the hard-negative mining. Returns
    (box_target (B, N * 4), box_mask (B, N * 4), cls_target (B, N)):
    cls_target 0 for background, the class + 1 where matched, and with
    ``negative_mining_ratio > 0`` ``ignore_label`` for the background
    anchors not mined.

    An anchor matches its best ground truth at IoU >= the threshold; each
    valid ground truth also claims its own best anchor (the larger
    ground-truth index wins a shared one; padding rows claim nothing:
    their scatter goes to a row past the anchors, which is dropped)."""
    def fn(anc, lab, cp):
        anc = anc[0]                                        # (N, 4)
        n, m = anc.shape[0], lab.shape[1]
        b = lab.shape[0]
        aw, ah, acx, acy = _anchor_centres(anc)
        valid = lab[..., 0] >= 0                            # (B, M)
        gt = lab[..., 1:5]
        iou = _corner_iou(anc[None], gt)                    # (B, N, M)
        iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
        best_iou = iou.amax(dim=2)
        best_gt = torch.argmax(iou, dim=2)                  # the first max
        best_anchor = torch.argmax(iou, dim=1)              # (B, M)
        safe = torch.where(valid, best_anchor,
                           torch.full_like(best_anchor, n))
        gt_ids = torch.arange(m, device=lab.device).expand(b, m)
        forced = torch.zeros((b, n + 1), dtype=torch.bool,
                             device=lab.device).scatter(
            1, safe, torch.ones_like(safe, dtype=torch.bool))[:, :n]
        forced_gt = torch.zeros((b, n + 1), dtype=torch.long,
                                device=lab.device).scatter_reduce(
            1, safe, gt_ids, "amax")[:, :n]
        gt_idx = torch.where(forced, forced_gt, best_gt)    # (B, N)
        matched = (best_iou >= overlap_threshold) | forced

        g = _take_rows(gt, gt_idx)                          # (B, N, 4)
        gw = (g[..., 2] - g[..., 0]).clamp(min=1e-12)
        gh = (g[..., 3] - g[..., 1]).clamp(min=1e-12)
        gcx = (g[..., 0] + g[..., 2]) / 2
        gcy = (g[..., 1] + g[..., 3]) / 2
        # each variance a 0-d tensor on the device (a fill, no copy):
        # a card divides by a Python number through its reciprocal
        v = [torch.full((), vi, dtype=aw.dtype, device=aw.device)
             for vi in variances]
        bt = torch.stack([(gcx - acx) / aw / v[0], (gcy - acy) / ah / v[1],
                          torch.log(gw / aw) / v[2],
                          torch.log(gh / ah) / v[3]], -1)   # (B, N, 4)
        bt = torch.where(matched[..., None], bt, torch.zeros_like(bt))
        mask = matched[..., None].to(bt.dtype).expand(b, n, 4)
        cls_lab = torch.gather(lab[..., 0], 1, gt_idx)
        cls_t = torch.where(matched, cls_lab + 1.0,
                            torch.zeros_like(cls_lab))
        if negative_mining_ratio > 0:
            # hard negatives: the background anchors the net is least
            # sure of first; near misses (IoU >= negative_mining_thresh)
            # are not candidates
            bg_prob = torch.softmax(cp, dim=1)[:, 0]        # (B, N)
            candidate = ~matched & (best_iou < negative_mining_thresh)
            neg_score = torch.where(candidate, bg_prob,
                                    torch.full_like(bg_prob, float("inf")))
            n_pos = matched.sum(1).clamp(min=1)
            n_neg = (negative_mining_ratio * n_pos).to(torch.int32) \
                .clamp(min=int(minimum_negative_samples))
            n_neg = torch.minimum(n_neg, candidate.sum(1).to(torch.int32))
            order = torch.argsort(neg_score, dim=1, stable=True)
            rank = torch.empty_like(order).scatter_(
                1, order, torch.arange(n, device=lab.device).expand(b, n))
            keep_neg = candidate & (rank < n_neg[:, None])
            cls_t = torch.where(matched | keep_neg, cls_t,
                                torch.full_like(cls_t, float(ignore_label)))
        return bt.reshape(b, -1), mask.reshape(b, -1), cls_t

    return invoke("MultiBoxTarget", fn, anchor, label, cls_pred)


def MultiBoxDetection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                      background_id=0, nms_threshold=0.5,
                      force_suppress=False, variances=_SSD_VAR,
                      nms_topk=-1):
    """Decode the box predictions and suppress by class: cls_prob (B,
    classes + 1, N); loc_pred (B, N * 4); anchor (1, N, 4) -> (B, N, 6)
    rows ``[cls_id, score, x1, y1, x2, y2]`` sorted by score, suppressed
    rows -1; cls_id counts the classes without ``background_id``."""
    def fn(cp, lp, anc):
        b = cp.shape[0]
        anc = anc[0]
        n = anc.shape[0]
        aw, ah, acx, acy = _anchor_centres(anc)
        # jnp widens bf16 offsets against the float32 variances; torch
        # would keep bf16 against a 0-d tensor or a Python number
        loc = lp.to(torch.promote_types(lp.dtype, torch.float32)) \
            .reshape(b, n, 4)
        v = variances
        cx = loc[..., 0] * v[0] * aw + acx
        cy = loc[..., 1] * v[1] * ah + acy
        w = torch.exp(loc[..., 2] * v[2]) * aw
        h = torch.exp(loc[..., 3] * v[3]) * ah
        boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                            -1)                             # (B, N, 4)
        if clip:
            boxes = boxes.clamp(0.0, 1.0)
        scores_all = cp.movedim(1, 2)                       # (B, N, C+1)
        fg = torch.cat([scores_all[..., :background_id],
                        scores_all[..., background_id + 1:]], -1)
        score, _ = fg.max(dim=-1)
        cls_id = torch.argmax(fg, dim=-1).to(torch.float32)
        keep = score > threshold
        # torch.cat promotes as jnp.concatenate does
        return torch.cat([torch.where(keep, cls_id, -1.0)[..., None],
                          torch.where(keep, score, -1.0)[..., None], boxes],
                         -1)

    raw = invoke("MultiBoxDetection_decode", fn, cls_prob, loc_pred, anchor)
    return box_nms(raw, overlap_thresh=nms_threshold, valid_thresh=threshold,
                   topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                   force_suppress=force_suppress)
