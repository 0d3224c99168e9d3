"""Training and evaluation steps (port of ``axcnn/train/train_step.py``).

``make_train_step`` with the KD teacher, gradient accumulation, data
parallelism and device AutoAugment. In the reference's order: device
AutoAugment on the uint8 batch (``autoaugment_fn``, drawn from the step's
``"autoaugment"`` stream), normalize, mixup, ``progress = step / total``,
forward (train-mode BN, DropBlock) and loss (+ KD), backward, momentum SGD
with masked weight decay, EMA. The state is updated in place: parameters, velocity, EMA and
the BN moving statistics.
``make_eval_step`` evaluates with the EMA swap (BASELINE config 3).

Data parallelism (a process ``group``, one rank per card, each with the
whole state and its shard of the batch) follows
``axcnn/train/train_step.py:130-230``: per-sample draws (DropBlock) come
and the AutoAugment draws come from the step's stream folded with the
rank, mixup's lambda from the stream before the fold (one lambda for the global batch) unless
``mixup_per_shard``; BN averages its statistics over the ranks
(``sync_bn``); after the backward (after the last micro-batch) the
gradients, the loss, the BN moving statistics and the metrics
``train_top1`` and ``mixup_lam`` are averaged over the ranks, in one
all-reduce for each dtype among them. DropBlock's scale stays each shard's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from axcnn_torch.core.dtypes import DEFAULT_POLICY, Policy
from axcnn_torch.core.rng import RngStream
from axcnn_torch.data.mixup import draw_lambda, mixup_batch
from axcnn_torch.data.preprocessing import normalize_device
from axcnn_torch.models.resnet import ModelConfig, ResNet
from axcnn_torch.parallel.mesh import all_reduce_mean_, all_reduce_sum_
from axcnn_torch.train.ema import ema_init, ema_update
from axcnn_torch.train.losses import decay_mask, kd_loss, softmax_ce_loss
from axcnn_torch.train.optimizer import momentum_init, momentum_update


@dataclasses.dataclass
class TrainState:
    model: ResNet  # parameters + BN moving statistics (buffers)
    ema: dict | None  # EMA shadow of the parameters, by name; None when off
    step: int = 0
    velocity: dict | None = None  # momentum buffers, by parameter name


def create_train_state(cfg: ModelConfig, *, generator: torch.Generator,
                       device, use_ema: bool = True) -> TrainState:
    """Random-init the model on the host from ``generator``, then move it to
    ``device`` with channels_last weights. Velocity starts at zero and the
    EMA as a copy of the parameters, as in the reference."""
    model = ResNet(cfg, generator=generator).to(
        device, memory_format=torch.channels_last).eval()
    params = dict(model.named_parameters())
    return TrainState(model=model, ema=ema_init(params) if use_ema else None,
                      velocity=momentum_init(params))


def load_ema(state: TrainState) -> None:
    """Copy the EMA weights into the model, once, for serving. Serving never
    updates them, so its forwards need no per-call swap; ``make_eval_step``
    keeps both sets live and swaps per call instead."""
    if state.ema is None:
        return
    result = state.model.load_state_dict(state.ema, strict=False)
    assert not result.unexpected_keys, result.unexpected_keys


def make_train_step(cfg: ModelConfig, *, lr_schedule, total_steps: int,
                    policy: Policy = DEFAULT_POLICY, label_smoothing: float = 0.0,
                    mixup_alpha: float = 0.0, mixup_symmetric: bool = False,
                    weight_decay: float = 1e-4, momentum: float = 0.9,
                    use_ema: bool = True, ema_decay: float = 0.9999,
                    teacher: ResNet | None = None, kd_temp: float = 1.0,
                    kd_alpha: float = 1.0, mean_rgb=None, stddev_rgb=None,
                    grad_accum_steps: int = 1, group=None, sync_bn: bool = True,
                    mixup_per_shard: bool = False, autoaugment_fn=None):
    """Builds ``train_step(state, batch, root_seed) -> (state, metrics)``.

    ``batch`` = {'images': uint8 NHWC, 'labels': int N}, on the state's
    device. Per-step streams are folded from ``root_seed`` and the step, so
    a run is reproducible. ``metrics`` holds ``loss`` and ``train_top1`` as
    0-d device tensors (no host sync), ``lr`` and ``mixup_lam`` as floats.

    ``teacher``, a frozen ``ResNet`` in eval mode, adds ``kd_alpha *
    kd_loss(logits, teacher logits, kd_temp)``; it runs under ``no_grad`` on
    the mixed images with the student's policy.

    ``grad_accum_steps = A > 1`` splits the batch into A micro-batches, as
    the reference does: micro-batch ``i`` draws DropBlock, AutoAugment and
    mixup (one lambda each) from the step's ``"accum"`` stream folded with
    ``i``; BN
    uses its statistics and updates the moving ones, micro by micro; the
    gradients, loss, top-1 and lambda are means over the micro-batches; one
    SGD and one EMA update follow. Activations live for one micro-batch.

    ``autoaugment_fn`` (``axcnn_torch.data.autoaugment_device``'s) augments
    each (micro-)batch on its device before normalization, from the
    ``"autoaugment"`` stream of its rng.

    ``lam=``, ``dropblock_uniforms=`` (a dict by site name) and ``aa_draws=``
    (``draw_autoaugment``'s form) replace the step's own random draws, one
    entry per micro-batch when ``A > 1``; they let a CPU test hand in the
    reference's.

    ``group`` (a process group of several ranks; None: one process) makes
    it the data-parallel step of the module docstring; ``batch`` is then
    this rank's shard. With it, ``mixup_lam`` is a 0-d device tensor too.
    """
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    A = grad_accum_steps
    bn_group = group if sync_bn else None
    mask = None

    def micro_step(model, images_u8, labels, rng, mix_rng, progress, lam, uniforms,
                   aa_draws):
        """Forward and backward of one (micro-)batch; the gradients add up in
        ``.grad``. Returns (loss, top-1, lambda)."""
        if autoaugment_fn is not None:
            images_u8 = autoaugment_fn(images_u8, None if aa_draws is not None
                                       else rng.numpy("autoaugment"), draws=aa_draws)
        images = normalize_device(images_u8, mean_rgb, stddev_rgb)
        labels_b = None
        if mixup_alpha > 0:
            if lam is None:
                lam = draw_lambda(mix_rng.numpy("mixup"), mixup_alpha,
                                  symmetric=mixup_symmetric)
            images, labels_a, labels_b = mixup_batch(images, labels, lam)
        else:
            labels_a, lam = labels, np.float32(1.0)
        logits = model(images, train=True, policy=policy, rng=rng,
                       progress=progress, dropblock_uniforms=uniforms, group=bn_group)
        loss = softmax_ce_loss(logits, labels_a, labels_b, float(lam),
                               label_smoothing=label_smoothing)
        if teacher is not None:
            with torch.no_grad():
                t_logits = teacher(images, policy=policy)
            loss = loss + kd_alpha * kd_loss(logits, t_logits, temperature=kd_temp)
        loss.backward()
        with torch.no_grad():
            top1 = (logits.argmax(-1) == labels).float().mean()
        return loss.detach(), top1, np.float32(lam)

    def train_step(state: TrainState, batch, root_seed: int, *, lam=None,
                   dropblock_uniforms=None, aa_draws=None):
        nonlocal mask
        model = state.model
        if model.cfg != cfg:
            raise ValueError("train_step built for another model config")
        if mask is None:
            mask = decay_mask(model)
        step = state.step
        # the global stream is the same on every rank; the per-sample draws
        # come from the rank's fold of it
        rng_global = RngStream(root_seed).fold_step(step)
        rng = rng_global if group is None else rng_global.fold_shard(dist.get_rank(group))
        mix_rng = rng if mixup_per_shard else rng_global
        progress = np.float32(step) / np.float32(max(total_steps, 1))
        images, labels = batch["images"], batch["labels"]
        if A == 1:
            micros = [(images, labels, rng, mix_rng, lam, dropblock_uniforms, aa_draws)]
        else:
            n = labels.shape[0]
            if n % A:
                raise ValueError(f"batch {n} not divisible by grad_accum_steps {A}")
            m = n // A
            accum, mix_accum = RngStream(rng("accum")), RngStream(mix_rng("accum"))
            lams = [None] * A if lam is None else list(lam)
            unis = [None] * A if dropblock_uniforms is None else list(dropblock_uniforms)
            aas = [None] * A if aa_draws is None else list(aa_draws)
            if len(lams) != A or len(unis) != A or len(aas) != A:
                raise ValueError(f"lam, dropblock_uniforms and aa_draws take {A} "
                                 "entries, one per micro-batch")
            micros = [(images[i * m:(i + 1) * m], labels[i * m:(i + 1) * m],
                       accum.fold_step(i), mix_accum.fold_step(i), lams[i], unis[i], aas[i])
                      for i in range(A)]

        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss = top1 = None
        lam_sum = np.float32(0.0)
        for images_i, labels_i, rng_i, mix_i, lam_i, uni_i, aa_i in micros:
            loss_i, top1_i, lam_i = micro_step(model, images_i, labels_i, rng_i, mix_i,
                                               progress, lam_i, uni_i, aa_i)
            loss = loss_i if loss is None else loss + loss_i
            top1 = top1_i if top1 is None else top1 + top1_i
            lam_sum = lam_sum + lam_i
        grads = {k: p.grad for k, p in params.items()}
        if A > 1:
            torch._foreach_div_(list(grads.values()), float(A))
            loss, top1 = loss / A, top1 / A
        lam_mean = lam_sum / np.float32(A)
        if group is not None:
            lam_mean = torch.tensor(lam_mean, device=loss.device)
            all_reduce_mean_([*grads.values(), *model.buffers(), loss, top1, lam_mean], group)

        lr = float(lr_schedule(step))
        momentum_update(params, grads, state.velocity, lr=lr, momentum=momentum,
                        weight_decay=weight_decay, mask=mask)
        for p in params.values():
            p.grad = None
        if use_ema and state.ema is not None:
            ema_update(state.ema, params, decay=ema_decay, step=step)

        metrics = {"loss": loss, "lr": lr, "train_top1": top1}
        if mixup_alpha > 0:
            metrics["mixup_lam"] = lam_mean if group is not None else float(lam_mean)
        state.step = step + 1
        return state, metrics

    return train_step


def eval_logits(state: TrainState, images_u8, *, policy: Policy = DEFAULT_POLICY,
                use_ema: bool = False, mean_rgb=None, stddev_rgb=None):
    """uint8 NHWC batch -> fp32 logits, with the EMA weights swapped in when
    ``use_ema`` (the reference's EMA-swap scaffold)."""
    x = normalize_device(images_u8, mean_rgb, stddev_rgb)
    with torch.inference_mode():
        if use_ema and state.ema is not None:
            return functional_call(state.model, state.ema, (x,),
                                   {"policy": policy})
        return state.model(x, policy=policy)


def topk_correct(logits, labels, ks=(1, 5)):
    """Returns {f'top{k}': count of correct} (sums, not means)."""
    out = {}
    for k in ks:
        kk = min(k, logits.shape[-1])  # few-class datasets: top-5 of 3 classes
        topk = torch.topk(logits, kk, dim=-1).indices
        correct = (topk == labels[:, None]).any(dim=-1)
        out[f"top{k}"] = correct.float().sum()
    return out


def make_eval_step(cfg: ModelConfig, *, policy: Policy = DEFAULT_POLICY,
                   use_ema: bool = False, mean_rgb=None, stddev_rgb=None, group=None):
    """Builds ``eval_step(state, batch) -> metrics`` (sums + count, so the
    caller aggregates exactly over uneven final batches). ``cfg`` is the
    model config the state was built from. With a process ``group`` the
    sums are over every rank's batch (one all-reduce), so every rank must
    call it equally often."""

    def eval_step(state: TrainState, batch):
        if state.model.cfg != cfg:
            raise ValueError("eval_step built for another model config")
        logits = eval_logits(state, batch["images"], policy=policy,
                             use_ema=use_ema, mean_rgb=mean_rgb,
                             stddev_rgb=stddev_rgb)
        labels = batch["labels"]
        # padded rows carry label -1: never correct, and masked out of loss/count
        valid = (labels >= 0).float()
        metrics = topk_correct(logits, labels)
        metrics["count"] = valid.sum()
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(1, labels.clamp(min=0)[:, None])[:, 0]
        metrics["loss_sum"] = (nll * valid).sum()
        all_reduce_sum_(metrics.values(), group)
        return metrics

    return eval_step


def pad_batch(batch, batch_size: int):
    """Pad a short final eval batch to ``batch_size`` (labels -> -1)."""
    images, labels = batch["images"], batch["labels"]
    pad = batch_size - labels.shape[0]
    if pad == 0:
        return batch
    return {
        "images": torch.cat([images, images.new_zeros((pad,) + images.shape[1:])]),
        "labels": torch.cat([labels, labels.new_full((pad,), -1)]),
    }
