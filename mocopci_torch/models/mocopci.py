"""MoCoPCI forward, eval and train (port of ``mocopci_tpu/models/mocopci.py``).

  - ``PointConvEncoder``: shared 5-level PointConv feature pyramid, run once
    over both clouds stacked on the batch axis.
  - ``MultiframeAttention``: per-level decoder stage; the 3 candidate frames
    are folded into the batch axis.
  - ``MultiFrameEstimator``: coarse-to-fine decoder, refine head and the
    kNN-softmax fusion head (k-major pairs p = j·N + n): BatchNorm folded into
    one pair kernel in eval, the planes kernel and ``fusion_head_train`` (batch
    statistics per frame group) in train.
  - ``MoCoPCI`` and the entry point :func:`interpolate`; ``MoCoPCI(...)(xyz1,
    xyz2, train=True, rng=generator)`` also returns the multi-scale frames the
    training loss reads.  With ``ModelConfig.remat`` the train forward under
    autograd recomputes four decoder stages in the backward (JAX's
    ``nn.remat`` sites: ``multi_frame_up_2``, ``multi_frame_up_1``,
    ``_refine`` and ``_fusion``; :func:`remat_stage`).

Channels-last (B, N, C) at every function, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mocopci_torch import ops
from mocopci_torch.config import ModelConfig
from mocopci_torch.device import resolve_device
from mocopci_torch.kernels import fold_bn_dense, fusion_head_train, fusion_pair, fusion_pair_planes
from mocopci_torch.nn.attention import CrossFrameBlock, EICrossformer, MultiFrameBlock
from mocopci_torch.nn.basic import (
    ConvLReLU,
    Dense,
    FrameBatchNorm,
    frozen_running_stats,
    init_weights,
)
from mocopci_torch.nn.cross import (
    BidirectionalLayerFeatCosine,
    CrossLayerFeatCosine,
    FlowEmbeddingLayer,
)
from mocopci_torch.nn.pointconv import PointConv, PointConvD
from mocopci_torch.nn.transformer import PointTransformerBlock


def time_embedding(ts: Sequence[float], dim: int) -> np.ndarray:
    """Sinusoidal time embedding table (len(ts), dim), the reference's loop."""
    enc = np.zeros((len(ts), dim), np.float32)
    for i, t in enumerate(ts):
        for j in range(0, dim, 2):
            enc[i, j] = math.sin(t * math.pow(10000, -j / dim))
            if j + 1 < dim:
                enc[i, j + 1] = math.cos(t * math.pow(10000, -(j + 1) / dim))
    return enc


def area_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """A (n_out, n_in) with A @ x == F.interpolate(x, n_out, mode="area")."""
    A = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        start = (i * n_in) // n_out
        end = -(-((i + 1) * n_in) // n_out)
        A[i, start:end] = 1.0 / (end - start)
    return A


def _rev_frames(x):
    return torch.flip(x, dims=(1,))


def remat_stage(owner: nn.Module, fn, *args, rng: Optional[torch.Generator] = None):
    """``fn(*args)``, with ``rng=rng`` where a generator is given, under
    non-reentrant ``torch.utils.checkpoint``: the stage keeps no activations
    and runs again in the backward.  Checkpoint's RNG stash covers only the
    default generators, so the stage draws from a copy of ``rng`` made at its
    start; the recompute draws from another copy of that state, so it replays
    the forward's dropout masks, and ``rng`` ends where the stage without
    remat leaves it.  During the recompute every ``FrameBatchNorm`` of
    ``owner`` is frozen: the step's EMA moves the running statistics once."""
    if rng is None:
        def run(*a):
            return fn(*a)
    else:
        start, end = rng.get_state(), []

        def run(*a):
            gen = torch.Generator(device=rng.device)
            gen.set_state(start)
            out = fn(*a, rng=gen)
            if not end:
                end.append(gen.get_state())
            return out
    out = checkpoint(run, *args, use_reentrant=False,
                     context_fn=lambda: (contextlib.nullcontext(), frozen_running_stats(owner)))
    if rng is not None:
        rng.set_state(end[0])
    return out


def _upsample_feats_and_frames(dense_xyz, sparse_xyz, feats, frames):
    """One shared-geometry upsample for feature fields + (B, F, S, 3) flows."""
    B, F, S, _ = frames.shape
    flows_cat = frames.permute(0, 2, 1, 3).reshape(B, S, F * 3)
    res = ops.upsample_multi(dense_xyz, sparse_xyz, list(feats) + [flows_cat])
    up = res[-1].reshape(B, dense_xyz.shape[1], F, 3).permute(0, 2, 1, 3)
    return tuple(res[:-1]), up


def _upsample_feat_and_frames(dense_xyz, sparse_xyz, feat, frames):
    feats = () if feat is None else (feat,)
    ups, up_frames = _upsample_feats_and_frames(dense_xyz, sparse_xyz, feats, frames)
    return (ups[0] if feat is not None else None), up_frames


class PointConvEncoder(nn.Module):
    """Shared 5-level PointConv feature pyramid."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        c0, c1, c2, c3, c4 = cfg.enc_channels
        n1, n2, n3, n4 = cfg.pyramid
        k, w = cfg.feat_nei, cfg.weightnet
        self.level0_lift = ConvLReLU(3, c0)
        self.level0 = PointConv(k, c0, c0, w)
        self.level0_1 = ConvLReLU(c0, c1)
        self.level1 = PointConvD(n1, k, c1, c1, w)
        self.level1_0 = ConvLReLU(c1, c1)
        self.level1_1 = ConvLReLU(c1, c2)
        self.level2 = PointConvD(n2, k, c2, c2, w)
        self.level2_0 = ConvLReLU(c2, c2)
        self.level2_1 = ConvLReLU(c2, c3)
        self.level3 = PointConvD(n3, k, c3, c3, w)
        self.level3_0 = ConvLReLU(c3, c3)
        self.level3_1 = ConvLReLU(c3, 2 * c3)
        self.level4 = PointConvD(n4, k, 2 * c3, c4, w)

    def forward(self, xyz):
        fps_idx = ops.farthest_point_sample_pyramid(xyz, self.cfg.pyramid)
        feat = self.level0_lift(xyz)                           # xyz doubles as colour
        feat_l0 = self.level0(xyz, feat)
        f = self.level0_1(feat_l0)
        pc_l1, feat_l1 = self.level1(xyz, f, fps_idx[0])
        feat_l1 = self.level1_0(feat_l1)
        f = self.level1_1(feat_l1)
        pc_l2, feat_l2 = self.level2(pc_l1, f, fps_idx[1])
        feat_l2 = self.level2_0(feat_l2)
        f = self.level2_1(feat_l2)
        pc_l3, feat_l3 = self.level3(pc_l2, f, fps_idx[2])
        feat_l3 = self.level3_0(feat_l3)
        f = self.level3_1(feat_l3)
        pc_l4, feat_l4 = self.level4(pc_l3, f, fps_idx[3])
        return [xyz, pc_l1, pc_l2, pc_l3, pc_l4], [feat_l0, feat_l1, feat_l2, feat_l3, feat_l4]


class MultiframeAttention(nn.Module):
    """Per-level decoder stage: for each candidate flow warp pc2, re-correlate,
    embed the motion; then attend over the 5 time tokens."""

    def __init__(self, feat_ch: int, latent_ch: int, mlp1, mlp2, flow_nei: int,
                 attn_drop: float = 0.05, proj_drop: float = 0.05, drop_path: float = 0.04):
        super().__init__()
        self.feat_ch = feat_ch
        self.flow_nei = flow_nei
        self.bid = BidirectionalLayerFeatCosine(flow_nei, 3 * feat_ch, mlp1)
        self.fe = FlowEmbeddingLayer(flow_nei, mlp1[-1], mlp2)
        self.cross_block = MultiFrameBlock(feat_ch, latent_ch, drop=proj_drop,
                                           attn_drop=attn_drop, drop_path=drop_path)
        self.downsample = ConvLReLU(latent_ch, feat_ch)

    def forward(self, pc1, pc2, feat1_new, feat2_new, feat1_0, feat1_1, feat2_0, feat2_1,
                up_frames, ts, train: bool = False, rng=None):
        c_feat1 = torch.cat([feat1_0, feat1_1, feat1_new], dim=-1)
        c_feat2 = torch.cat([feat2_0, feat2_1, feat2_new], dim=-1)
        B, F = up_frames.shape[:2]
        k_half = self.flow_nei // 2
        idx_cos_12 = ops.knn_cosine(k_half, feat2_0, feat1_0)
        idx_cos_21 = ops.knn_cosine(k_half, feat1_0, feat2_0)

        def rep(x):
            return x[:, None].expand((B, F) + x.shape[1:]).reshape((B * F,) + x.shape[1:])

        def fold(x):
            return x.reshape((B * F,) + x.shape[2:])

        pc1_r, pc2_r = rep(pc1), rep(pc2)
        pc2_warp = ops.point_warp(pc1_r, pc2_r, fold(up_frames))
        f1n_all, f2n_all = self.bid(
            pc1_r, pc2_warp, rep(c_feat1), rep(c_feat2), rep(feat1_0), rep(feat2_0),
            rep(idx_cos_12), rep(idx_cos_21),
        )
        fe_all = self.fe(pc1_r, pc2_warp, f1n_all, f2n_all, rep(feat1_0), rep(feat2_0),
                         rep(idx_cos_12))
        f1n_all = f1n_all.reshape((B, F) + f1n_all.shape[1:])
        f2n_all = f2n_all.reshape((B, F) + f2n_all.shape[1:])
        fe_all = fe_all.reshape((B, F) + fe_all.shape[1:])
        # the reference keeps the LAST iteration's bid outputs
        f1n, f2n = f1n_all[:, -1], f2n_all[:, -1]
        x = torch.cat([f1n[:, None], fe_all[:, :3], f2n[:, None]], dim=1)   # (B, 5, N, C)
        emb = torch.as_tensor(time_embedding(ts, self.feat_ch), device=x.device)
        x = x + emb[None, :, None, :]
        feats, frames = self.cross_block(x, train, rng)
        feats = self.downsample(feats)
        return frames, f1n, f2n, feats


class MultiFrameEstimator(nn.Module):
    """Coarse-to-fine bidirectional multi-frame flow decoder."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        c0, c1, c2, c3, c4 = cfg.enc_channels
        self.ei1 = EICrossformer(c1)
        self.ei2 = EICrossformer(c2)
        self.ei3 = EICrossformer(c3)
        self.deconv4_3 = ConvLReLU(c4, c1)
        self.deconv3_2 = ConvLReLU(c3, c2)
        self.deconv2_1 = ConvLReLU(c2, c1)
        self.cross3 = CrossLayerFeatCosine(cfg.flow_nei, 2 * c3 + c1, (c3, c3), (c3, c3))
        self.cross_block3 = CrossFrameBlock(c3, drop=cfg.proj_drop, attn_drop=cfg.attn_drop)
        rates = dict(attn_drop=cfg.attn_drop, proj_drop=cfg.proj_drop, drop_path=cfg.drop_path)
        self.multi_frame_up_2 = MultiframeAttention(c2, c1 + c1 * 4, (c2, c2), (c2, c2),
                                                    cfg.flow_nei, **rates)
        self.multi_frame_up_1 = MultiframeAttention(c1, c1 + c0 * 4, (c1, c1), (c1, c1),
                                                    cfg.flow_nei, **rates)
        # fusion head 4 -> 64 -> 64 -> 128 with BatchNorm (eps 1e-3) + ReLU
        self.fusion_conv0 = Dense(4, c1)
        self.fusion_conv1 = Dense(c1, c1)
        self.fusion_conv2 = Dense(c1, c2)
        self.fusion_bn0 = FrameBatchNorm(c1, eps=1e-3)
        self.fusion_bn1 = FrameBatchNorm(c1, eps=1e-3)
        self.fusion_bn2 = FrameBatchNorm(c2, eps=1e-3)
        # refine head
        self.rlevel0 = ConvLReLU(c0, c1)
        self.refine_level1 = PointConvD(cfg.refine_npoint, cfg.feat_nei, c1, c1, cfg.weightnet)
        self.shape1 = PointTransformerBlock(c1, cfg.refine_k)
        self.pred1 = Dense(c1, c0)
        self.pred2 = Dense(c0, 3)

    def _fusion(self, points1, points2, train: bool = False):
        """kNN-softmax position blend on (F·B, N, 3) clouds, frame-major.  Eval:
        BatchNorm folded into the dense layers, one fused pair kernel.  Train:
        the planes kernel, then ``fusion_head_train`` with batch statistics per
        frame group (the reference calls the fusion once per frame), whose
        statistics move the running ones."""
        k = self.cfg.fusion_k
        idx_both = ops.knn(k, torch.cat([points1, points2], dim=0),
                           torch.cat([points1, points1], dim=0))
        idx_self, idx_cross = torch.chunk(idx_both, 2, dim=0)
        idx = torch.cat([idx_self, idx_cross], dim=-1).contiguous()    # (FB, N, 2k)
        fb, n, k2 = idx.shape
        if train:
            F = self.cfg.n_frames
            planes = fusion_pair_planes(points2.float().contiguous(), idx,
                                        points1.float().contiguous())
            params, bns = [], []
            for i in range(3):
                dense = getattr(self, f"fusion_conv{i}")
                bn = getattr(self, f"fusion_bn{i}")
                params += [dense.weight.t().contiguous(), dense.bias, bn.weight, bn.bias]
                bns.append(bn)
            h, stats = fusion_head_train(planes, params, F, bns[0].eps)
            for bn, (mean, var) in zip(bns, stats):
                bn.ema_update(mean, var, (fb // F) * n * k2)
        else:
            planes, h = self._fusion_eval(points1, points2, idx)
        w = torch.softmax(h.reshape(fb, k2, n), dim=1)                 # (FB, 2k, N)
        # softmax weights sum to 1: sum w * neighbour = p1 + sum w * resi
        blend = torch.einsum("bkn,bckn->bnc", w, planes[:, :3].reshape(fb, 3, k2, n))
        return points1.float() + blend

    def _fusion_eval(self, points1, points2, idx):
        folded = []
        for i in range(3):
            dense = getattr(self, f"fusion_conv{i}")
            bn = getattr(self, f"fusion_bn{i}")
            w, b = fold_bn_dense(dense.weight.t(), dense.bias, bn.weight, bn.bias,
                                 bn.running_mean, bn.running_var, bn.eps)
            folded += [w.contiguous(), b.contiguous()]
        return fusion_pair(points2.float().contiguous(), idx,
                           points1.float().contiguous(), *folded)

    def _refine(self, feat0, base_pc, up_flow):
        """Full-resolution compensation head."""
        c0 = self.cfg.enc_channels[0]
        A = torch.as_tensor(area_resize_matrix(3, c0), device=feat0.device)
        warped_feat = self.rlevel0(feat0 + torch.einsum("bnc,dc->bnd", up_flow, A))
        down_xyz, down_feat = self.refine_level1(base_pc, warped_feat)
        shaped = self.shape1(down_feat, down_xyz)
        up = ops.upsample(base_pc, down_xyz, shaped)
        return self.pred2(torch.relu(self.pred1(up)))

    def forward(self, pc1s, pc2s, feat1s, feat2s, train: bool = False, rng=None):
        cfg = self.cfg
        F = cfg.n_frames
        t_f, t_b = cfg.t_forward, cfg.t_backward

        remat = cfg.remat and train and torch.is_grad_enabled()

        def stage(fn, *args, rng=None):
            """A decoder stage: under remat kept as no activations and run
            again in the backward (:func:`remat_stage`)."""
            if remat:
                return remat_stage(self, fn, *args, rng=rng)
            return fn(*args) if rng is None else fn(*args, rng=rng)

        fus1 = self.ei1(feat1s[1], feat2s[1], train)
        fus2 = self.ei2(feat1s[2], feat2s[2], train)
        fus3 = self.ei3(feat1s[3], feat2s[3], train)

        # L4 -> L3
        feat1_l4_3 = self.deconv4_3(ops.upsample(pc1s[3], pc1s[4], feat1s[4]))
        feat2_l4_3 = self.deconv4_3(ops.upsample(pc2s[3], pc2s[4], feat2s[4]))

        # L3 cost volume + one-shot frame synthesis (forward and backward)
        c_feat1_l3 = torch.cat([feat1s[3], fus3, feat1_l4_3], dim=-1)
        c_feat2_l3 = torch.cat([feat2s[3], fus3, feat2_l4_3], dim=-1)
        f1n_l3, f2n_l3 = self.cross3(pc1s[3], pc2s[3], c_feat1_l3, c_feat2_l3,
                                     feat1s[3], feat2s[3])
        _, frame3_f = self.cross_block3(torch.stack([f1n_l3, f2n_l3], dim=1), train, rng)
        _, frame3_b = self.cross_block3(torch.stack([f2n_l3, f1n_l3], dim=1), train, rng)

        # L3 -> L2
        feat1_l3_2, up_frame2_f = _upsample_feat_and_frames(pc1s[2], pc1s[3], f1n_l3, frame3_f)
        feat2_l3_2, up_frame2_b = _upsample_feat_and_frames(pc2s[2], pc2s[3], f2n_l3, frame3_b)
        feat1_l3_2 = self.deconv3_2(feat1_l3_2)
        feat2_l3_2 = self.deconv3_2(feat2_l3_2)

        # L2
        frame2_f, f1n_l2_f, f2n_l2_f, _ = stage(
            self.multi_frame_up_2, pc1s[2], pc2s[2], feat1_l3_2, feat2_l3_2,
            feat1s[2], fus2, feat2s[2], fus2, up_frame2_f, t_f, train, rng=rng)
        frame2_b, f2n_l2_b, f1n_l2_b, _ = stage(
            self.multi_frame_up_2, pc2s[2], pc1s[2], feat2_l3_2, feat1_l3_2,
            feat2s[2], fus2, feat1s[2], fus2, up_frame2_b, t_b, train, rng=rng)

        # L2 -> L1
        (feat1_l2_1_f, feat1_l2_1_b), up_frame1_f = _upsample_feats_and_frames(
            pc1s[1], pc1s[2], (f1n_l2_f, f1n_l2_b), frame2_f)
        (feat2_l2_1_f, feat2_l2_1_b), up_frame1_b = _upsample_feats_and_frames(
            pc2s[1], pc2s[2], (f2n_l2_f, f2n_l2_b), frame2_b)
        feat1_l2_1_f = self.deconv2_1(feat1_l2_1_f)
        feat2_l2_1_f = self.deconv2_1(feat2_l2_1_f)
        feat1_l2_1_b = self.deconv2_1(feat1_l2_1_b)
        feat2_l2_1_b = self.deconv2_1(feat2_l2_1_b)

        # L1
        frame1_f, _, _, _ = stage(
            self.multi_frame_up_1, pc1s[1], pc2s[1], feat1_l2_1_f, feat2_l2_1_f,
            feat1s[1], fus1, feat2s[1], fus1, up_frame1_f, t_f, train, rng=rng)
        frame1_b, _, _, _ = stage(
            self.multi_frame_up_1, pc2s[1], pc1s[1], feat2_l2_1_b, feat1_l2_1_b,
            feat2s[1], fus1, feat1s[1], fus1, up_frame1_b, t_b, train, rng=rng)

        # L1 -> L0; the backward branch uses time-reversed frame order
        _, up_frame0_f = _upsample_feat_and_frames(pc1s[0], pc1s[1], None, frame1_f)
        _, up_frame0_b = _upsample_feat_and_frames(pc2s[0], pc2s[1], None,
                                                   _rev_frames(frame1_b))

        # L0: warp, refine, fuse, with the 3 frames folded frame-major into the batch
        B = pc1s[0].shape[0]
        warped_f = pc1s[0][:, None] + up_frame0_f
        warped_b = pc2s[0][:, None] + up_frame0_b
        base = torch.cat([warped_f[:, 0], warped_f[:, 1], warped_b[:, 2]], dim=0)
        feat0 = torch.cat([feat1s[0], feat1s[0], feat2s[0]], dim=0)
        flows = torch.cat([up_frame0_f[:, 0], up_frame0_f[:, 1], up_frame0_b[:, 2]], dim=0)
        refine_out = stage(self._refine, feat0, base, flows)
        fused = stage(self._fusion, base, refine_out, train)      # (3B, N, 3)
        out = torch.stack([fused[i * B:(i + 1) * B] for i in range(F)], dim=1)
        result = {"out": out}                                     # (B, 3, N, 3)
        if train:
            # [warped, reverse-warped, L1, L2, L3] per direction, (B, 3, n_l, 3)
            result["frames_f"] = (
                warped_f, pc1s[0][:, None] + _rev_frames(up_frame0_b),
                pc1s[1][:, None] + frame1_f, pc1s[2][:, None] + frame2_f,
                pc1s[3][:, None] + frame3_f)
            result["frames_b"] = (
                warped_b, pc2s[0][:, None] + _rev_frames(up_frame0_f),
                pc2s[1][:, None] + _rev_frames(frame1_b),
                pc2s[2][:, None] + _rev_frames(frame2_b),
                pc2s[3][:, None] + _rev_frames(frame3_b))
        return result


class MoCoPCI(nn.Module):
    """Top-level model: ``model(xyz1, xyz2)["out"]`` is the (B, 3, N, 3)
    tensor of the three interpolated frames.  ``train=True`` uses batch
    statistics (moving the running ones), the train kernels with their
    backwards, dropout drawn from ``rng`` when one is given, and adds
    ``frames_f`` / ``frames_b`` for the loss.

    Parameters are drawn from ``torch.Generator().manual_seed(seed)`` and
    placed on ``device``: the card by default (raises without one), or
    ``"cpu"`` for the plain versions of every kernel.
    """

    def __init__(self, cfg: ModelConfig = ModelConfig(), device=None, seed: int = 0):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.encoder = PointConvEncoder(cfg)
        self.estimator = MultiFrameEstimator(cfg)
        init_weights(self, torch.Generator().manual_seed(seed))
        self.eval()
        self.to(self.device)

    def forward(self, xyz1, xyz2, train: bool = False, rng: Optional[torch.Generator] = None):
        B = xyz1.shape[0]
        pcs, feats = self.encoder(torch.cat([xyz1, xyz2], dim=0).float())
        pc1s = [p[:B] for p in pcs]
        pc2s = [p[B:] for p in pcs]
        feat1s = [f[:B] for f in feats]
        feat2s = [f[B:] for f in feats]
        return self.estimator(pc1s, pc2s, feat1s, feat2s, train, rng)


def interpolate(model: MoCoPCI, xyz1: Union[np.ndarray, torch.Tensor],
                xyz2: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
    """Eval forward: two (B, N, 3) clouds -> (B, 3, N, 3) interpolated frames,
    on the model's device."""
    model.eval()
    with torch.no_grad():
        x1 = torch.as_tensor(xyz1, dtype=torch.float32, device=model.device)
        x2 = torch.as_tensor(xyz2, dtype=torch.float32, device=model.device)
        return model(x1, x2)["out"]
