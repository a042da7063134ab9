"""InfoNCE / self-paced InfoNCE hooks — the paper's pretraining losses, on
encoder and decoder stages.

The counterpart of `spcl_tpu/hooks/infonce.py` (reference
semi_seg/hooks/infonce.py:56-141, 171-241):
  features of the two views <- ctx["acts"][stage][-2n:]
  view-1 features re-flipped with the step's flip params (geometry align)
  encoder stage: ProjectionHead -> z [n, 256] (L2-normalized)
  decoder stage: DenseProjectionHead -> z [n, 256, 10, 10]; `sample` draws
    5 points (ys, xs) per image on the pooled grid, the same points for both
    views; their [n·5, 256] rows are SimCLR-paired (each point's only
    positive is itself in the other view; target -1 on padded slices)
  loss = (SelfPaced)SupCon(z1, z2, target)

Criterion dispatch: `use_fused` "auto" or true runs `ops.supcon_cuda` —
the hand-written kernels on a CUDA tensor at EVERY batch size, their plain
per-row version on a CPU tensor; false runs the dense `losses/supcon.py`.
(`spcl_tpu`'s FUSED_MIN_ROWS crossover is a TPU measurement and does not
apply here.)

`global_contrast` says how the loss spans the ranks of a multi-rank run
(`Trainer.mesh`): "replicated" gathers z and computes the full [2N, 2N] loss
on every rank; "row_sharded" computes this rank's [2 n_local, 2N] strip
(`parallel/contrastive.py`). Both give the same loss and the same metrics on
every rank; in a single process both are the single-device loss. A decoder
hook draws its points for the global batch and keeps its rows'; the SimCLR
ids of its n·5 points start at this rank's first row times 5, so that they
are the global batch's ids (spcl_tpu hooks/infonce.py:133-155, 157-171).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .base import TrainerHook, global_rows, label_from_contrast_on, own_rows
from ..data.augment import apply_flip
from ..losses.supcon import self_paced_supcon_loss, supcon_loss
from ..models.heads import DenseProjectionHead, ProjectionHead
from ..models.stages import is_encoder_stage
from ..ops.supcon_cuda import fused_self_paced_supcon, fused_supcon
from ..parallel import mesh
from ..parallel.contrastive import global_self_paced_supcon, sharded_self_paced_supcon
from ..schedulers.gamma import PScheduler


class INFONCEHook(TrainerHook):
    def __init__(self, *, name: str, feature_name: str, weight: float = 1.0,
                 contrast_on: str = "partition",
                 spatial_size: Optional[Tuple[int, int]] = None,
                 temperature: float = 0.07, num_sampled_points: int = 5,
                 use_fused="auto", global_contrast: str = "replicated"):
        super().__init__(name, weight)
        if global_contrast not in ("replicated", "row_sharded"):
            raise ValueError(global_contrast)
        self.global_contrast = global_contrast
        self.use_fused = use_fused
        self.feature_name = feature_name
        self.contrast_on = contrast_on
        self.temperature = float(temperature)
        self.is_encoder = is_encoder_stage(feature_name)
        if spatial_size is None:
            spatial_size = (1, 1) if self.is_encoder else (10, 10)
        self.spatial_size = tuple(spatial_size)
        self.num_sampled_points = int(num_sampled_points)

    def build(self, model, device):
        head = ProjectionHead if self.is_encoder else DenseProjectionHead
        self.projector = head(input_dim=model.channel_dim(self.feature_name), output_dim=256,
                              hidden_dim=256, head_type="mlp", normalize=True,
                              spatial_size=self.spatial_size).to(device)
        return self.projector

    def sample(self, generator, ctx):
        """Decoder stages: the points of this step, ys and xs [n, 5] uniform
        over the pooled grid (spcl_tpu draws them from fold_in(key, 17))."""
        if self.is_encoder:
            return None
        h, w = self.spatial_size
        shape = (global_rows(ctx, ctx["n_unl"])[0], self.num_sampled_points)
        device = ctx["valid"].device
        return {"ys": torch.randint(0, h, shape, generator=generator, device=device),
                "xs": torch.randint(0, w, shape, generator=generator, device=device)}

    @property
    def fused(self) -> bool:
        return self.use_fused == "auto" or bool(self.use_fused)

    def _projected_views(self, ctx):
        n = ctx["n_unl"]
        feats = ctx["acts"][self.feature_name][-2 * n:]
        v1, v2 = feats[:n], feats[n:]
        # align view-1 features into the flipped frame (reference :177-179)
        v1_tf = apply_flip(v1, ctx["flip"])
        z = self.projector(torch.cat([v1_tf, v2], dim=0))
        return z[:n], z[n:]

    def _mesh_criterion(self, z1, z2, target, valid, *, gamma, mode, correct_grad=False):
        """(loss, ratio) over the global batch of a multi-rank run."""
        fn = (sharded_self_paced_supcon if self.global_contrast == "row_sharded"
              else global_self_paced_supcon)
        return fn(z1, z2, target, valid, gamma=gamma, temperature=self.temperature,
                  weight_update=mode, correct_grad=correct_grad, use_fused=self.use_fused)

    def _criterion(self, z1, z2, target, valid, scalars):
        if mesh.active():
            # hard weights at gamma = 1e9 are exactly 1: plain SupCon
            loss, _ = self._mesh_criterion(z1, z2, target, valid, gamma=1e9, mode="hard")
        elif self.fused:
            loss = fused_supcon(z1, z2, target=target, valid=valid,
                                temperature=self.temperature)
        else:
            loss, _ = supcon_loss(z1, z2, target=target, valid=valid,
                                  temperature=self.temperature)
        return loss, {"loss": loss}

    def loss_fn(self, ctx, scalars):
        z1, z2 = self._projected_views(ctx)
        if self.is_encoder:
            target, valid = label_from_contrast_on(ctx, self.contrast_on), ctx["valid"]
        else:
            z1, z2, target, valid = self._dense_points(z1, z2, ctx)
        loss, metrics = self._criterion(z1, z2, target, valid, scalars)
        return loss * self.weight, metrics

    def _dense_points(self, z1, z2, ctx):
        """The rows of the sampled points of both views [n·5, 256], their
        SimCLR targets and validity (spcl_tpu hooks/infonce.py:157-171)."""
        draws = ctx["draws"][self.name]
        n, d = z1.shape[:2]
        ys, xs = (own_rows(draws[k], ctx, n).long() for k in ("ys", "xs"))
        rows = torch.arange(n, device=z1.device)[:, None]
        # advanced indices apart around a slice: [n, 5, d]
        s1 = z1[rows, :, ys, xs].reshape(-1, d)
        s2 = z2[rows, :, ys, xs].reshape(-1, d)
        p = ys.shape[1]
        valid = ctx["valid"].repeat_interleave(p)
        first = global_rows(ctx, n)[1] * p
        ids = torch.arange(first, first + valid.shape[0], dtype=torch.int32,
                           device=valid.device)
        target = torch.where(valid > 0, ids, torch.full_like(ids, -1))
        return s1, s2, target, valid

    # ---- batch-0 diagnostics (reference :185-193: sim / mask figure dumps)
    def _views_and_labels(self, ctx):
        z1, z2 = self._projected_views(ctx)
        if self.is_encoder:
            return z1, z2, label_from_contrast_on(ctx, self.contrast_on), ctx["valid"]
        return self._dense_points(z1, z2, ctx)

    def matrices_fn(self, ctx, scalars) -> Dict[str, torch.Tensor]:
        """The [2N, 2N] matrices the reference plots on batch 0 of each epoch
        (spcl_tpu hooks/infonce.py:178-192), from the plain dense loss: the
        similarity logits, their exp, and the positive mask. Called by the
        once-an-epoch probe (`training/steps.py::build_matrix_probe`), never
        by the step."""
        z1, z2, target, valid = self._views_and_labels(ctx)
        _, aux = supcon_loss(z1, z2, target=target, valid=valid,
                             temperature=self.temperature, return_matrices=True)
        return {"sim_logits": aux.sim_logits, "sim_exp": torch.exp(aux.sim_logits),
                "pos_mask": aux.pos_mask}


class SelfPacedINFONCEHook(INFONCEHook):
    def __init__(self, *, name: str, feature_name: str, weight: float = 1.0,
                 contrast_on: str = "partition", spatial_size=None,
                 temperature: float = 0.07, mode: str = "soft", p: float = 0.5,
                 begin_value: float = 1e6, end_value: float = 1e6,
                 correct_grad: bool = False, max_epoch: int = 80,
                 num_sampled_points: int = 5, use_fused="auto",
                 global_contrast: str = "replicated"):
        super().__init__(name=name, feature_name=feature_name, weight=weight,
                         contrast_on=contrast_on, spatial_size=spatial_size,
                         temperature=temperature, num_sampled_points=num_sampled_points,
                         use_fused=use_fused, global_contrast=global_contrast)
        if mode not in ("soft", "hard"):
            raise ValueError(mode)
        self.mode = mode
        self.correct_grad = bool(correct_grad)
        self.scheduler = PScheduler(max_epoch=max_epoch, begin_value=begin_value,
                                    end_value=end_value, p=p)

    def epoch_scalars(self, epoch: int) -> Dict[str, float]:
        # reference :133-136: gamma read then scheduler stepped each epoch
        return {"gamma": float(self.scheduler.get_value(epoch))}

    def step_schedulers(self) -> None:
        self.scheduler.step()

    def _criterion(self, z1, z2, target, valid, scalars):
        gamma = scalars["gamma"]
        if mesh.active():
            loss, ratio = self._mesh_criterion(z1, z2, target, valid, gamma=gamma,
                                               mode=self.mode,
                                               correct_grad=self.correct_grad)
        elif self.fused:
            loss, ratio = fused_self_paced_supcon(
                z1, z2, target=target, valid=valid, gamma=gamma,
                temperature=self.temperature, weight_update=self.mode,
                correct_grad=self.correct_grad)
        else:
            loss, aux = self_paced_supcon_loss(
                z1, z2, target=target, valid=valid, gamma=gamma,
                temperature=self.temperature, weight_update=self.mode,
                correct_grad=self.correct_grad)
            ratio = aux.downgrade_ratio
        return loss, {"loss": loss, "sp_weight": ratio, "age_param": gamma}

    def matrices_fn(self, ctx, scalars) -> Dict[str, torch.Tensor]:
        """Adds the self-paced weight mask (reference :263-266 plots sp_mask;
        spcl_tpu hooks/infonce.py:256-268)."""
        z1, z2, target, valid = self._views_and_labels(ctx)
        _, aux = self_paced_supcon_loss(
            z1, z2, target=target, valid=valid, gamma=scalars["gamma"],
            temperature=self.temperature, weight_update=self.mode,
            correct_grad=self.correct_grad, return_matrices=True)
        return {"sim_logits": aux.sim_logits, "sim_exp": torch.exp(aux.sim_logits),
                "pos_mask": aux.pos_mask, "sp_mask": aux.sp_mask}

    def state_dict(self):
        return {"scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state):
        self.scheduler.load_state_dict(state["scheduler"])
