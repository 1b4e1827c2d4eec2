"""Step builders: the loss and its gradients, the train step, the
prefill step and the serve step (port of `repro.distributed.step`).

The cross-entropy is evaluated in sequence chunks when the config's
`logits_chunk` divides the sequence, so the (B, S, V) logits of a 150k
vocabulary never exist at once; while autograd records, each chunk runs
under a checkpoint, so backward recomputes its logits instead of keeping
all of them (the reference's `jax.checkpoint` body).  A mean is a sum
times f32(1/n), as the jitted reference computes it.

`make_train_step` is `jax.value_and_grad` of the loss (torch autograd)
and the in-place AdamW update (`optim.adamw`).  Training runs the torch
routes only, as the reference's runs its XLA routes: the CUDA kernels
are forward-only, so a policy whose linears or attention resolve to a
kernel route is refused (`check_trainable`).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import exec_plan
from repro_torch.core.policy import get_policy
from repro_torch.core.quantize import recip
from repro_torch.core.tree import flatten_with_paths, tree_map_with_path
from repro_torch.kernels.build import BACKWARD_ITEM
from repro_torch.models import layers as L
from repro_torch.optim import adamw
from repro_torch.serving.sampler import greedy_tokens

COLLECTIVES_ITEM = ("ROADMAP Queue 1, \"Tensor-parallel serving and "
                    "collectives\"")


def _logsumexp(logits):
    """log(sum(exp(x - max))) + max over the last dim; the max carries no
    gradient, as in `jax.scipy.special.logsumexp`."""
    m = logits.amax(dim=-1, keepdim=True).detach()
    return (torch.log(torch.exp(logits - m).sum(dim=-1, keepdim=True))
            + m)[..., 0]


def _xent_terms(logits, labels):
    """-> (logz, gold) per position."""
    logz = _logsumexp(logits)
    gold = logits.gather(-1, labels[..., None].to(torch.int64))[..., 0]
    return logz, gold


def softmax_xent(logits, labels, z_coef: float = 1e-4):
    """logits (B, S, V) f32, labels (B, S) int -> scalar mean loss
    (+ z-loss)."""
    logz, gold = _xent_terms(logits, labels)
    inv_n = recip(logz.numel())
    loss = (logz - gold).sum() * inv_n
    if z_coef:
        loss = loss + z_coef * ((logz * logz).sum() * inv_n)
    return loss


def chunked_xent(params, model, x, labels, chunk: int,
                 z_coef: float = 1e-4):
    """Per-chunk unembed + cross-entropy over x (B, S, d): never holds
    more than (B, chunk, V) logits, in backward too."""
    B, S, _ = x.shape
    table = model.unembed_table(params)

    def body(xs, ls):
        logz, gold = _xent_terms(L.apply_unembed(xs, table), ls)
        return (logz - gold).sum() + z_coef * (logz * logz).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        part = (checkpoint(body, x[:, sl], labels[:, sl],
                           use_reentrant=False, preserve_rng_state=False)
                if torch.is_grad_enabled() and x.requires_grad
                else body(x[:, sl], labels[:, sl]))
        total = total + part
    return total * recip(B * S)


def make_loss_fn(model):
    """-> loss_fn(params, batch) -> (loss + aux, {"loss", "aux"}); batch
    {"tokens", "labels"}, the VLM's {"embeddings", "labels"} or the
    encoder-decoder's {"frames", "tokens", "labels"}; differentiable."""
    cfg = model.cfg

    def loss_fn(params, batch):
        seq = batch["labels"].shape[1]
        chunk = min(cfg.logits_chunk, seq) if cfg.logits_chunk else 0
        if chunk and seq % chunk == 0:
            x, aux = model.backbone_features(params, batch)
            loss = chunked_xent(params, model, x, batch["labels"], chunk)
        else:
            logits, aux = model.train_logits(params, batch)
            loss = softmax_xent(logits, batch["labels"])
        return loss + aux, {"loss": loss, "aux": aux}

    return loss_fn


def value_and_grad(loss_fn):
    """`jax.value_and_grad(loss_fn, has_aux=True)` over a params tree ->
    fn(params, batch) -> ((total, parts), grads in params' structure).
    Marks every param leaf as requiring grad.  The one leaf a loss may
    leave unused is the token table of a batch that carries "embeddings"
    (the VLM's stub front end): it gets zeros, as in JAX.  Any other
    unused leaf raises: a port fault has cut it off the loss."""
    def fn(params, batch):
        paths = flatten_with_paths(params)
        flat = [leaf.requires_grad_(True) for _, leaf in paths]
        with torch.enable_grad():
            total, parts = loss_fn(params, batch)
        may_skip = {("embed", "table")} if "embeddings" in batch else set()
        grads = {}
        for (path, x), g in zip(paths, torch.autograd.grad(
                total, flat, allow_unused=True)):
            if g is None and path not in may_skip:
                raise RuntimeError(f"param {'.'.join(path)} does not reach "
                                   "the loss")
            grads[path] = torch.zeros_like(x) if g is None else g
        return (total.detach(), {k: torch.as_tensor(v).detach()
                                 for k, v in parts.items()}), \
            tree_map_with_path(lambda path, _: grads[path], params)
    return fn


def check_trainable(model) -> None:
    """Refuse a policy whose linears, expert stacks or attention resolve
    to a CUDA kernel route: the kernels are forward-only."""
    cfg = model.cfg
    pol = get_policy(cfg.policy)
    routes = {"matmul": exec_plan.resolve("matmul", pol,
                                          w_dtype="float32"),
              "flash_attn": exec_plan.resolve("flash_attn", pol, sq=2,
                                              skv=2,
                                              use_flash=cfg.use_flash)}
    if cfg.is_moe:
        routes["grouped_matmul"] = exec_plan.resolve(
            "grouped_matmul", pol, w_dtype="float32", eq="becd,edf->becf")
    kernels = {op: e.name for op, e in routes.items() if e.backend == "cuda"}
    if kernels:
        raise NotImplementedError(
            f"policy {cfg.policy!r} (use_flash={cfg.use_flash}) routes "
            f"{kernels} to CUDA kernels, which have no backward pass "
            f"({BACKWARD_ITEM}); train under a policy whose routes are "
            "plain PyTorch, as the reference trains through its XLA "
            "routes")


def make_train_step(model, opt_cfg: adamw.AdamWConfig):
    """-> train_step(state, batch) -> (state, metrics): the loss and its
    gradients, then the in-place AdamW update.  state {"params", "opt"};
    metrics "loss", "aux", "total", "grad_norm", "lr" (0-dim tensors on
    the state's device)."""
    check_trainable(model)
    grad_fn = value_and_grad(make_loss_fn(model))

    def train_step(state, batch):
        params, opt_state = state["params"], state["opt"]
        (total, parts), grads = grad_fn(params, batch)
        params, opt_state, om = adamw.update(opt_cfg, grads, opt_state,
                                             params, model.decay_mask(params))
        metrics = {"loss": parts["loss"], "aux": parts["aux"],
                   "total": total, **om}
        return {"params": params, "opt": opt_state}, metrics

    return train_step


def make_compressed_train_step(model, opt_cfg, mesh, fmt_name="fp8_e4m3",
                               axis="data"):
    """The data-parallel step with wire-compressed gradient reduction
    needs collectives the port does not have yet."""
    raise NotImplementedError(
        f"make_compressed_train_step reduces gradients across devices: "
        f"{COLLECTIVES_ITEM}")


def make_prefill_step(model):
    """-> prefill_step(params, tokens (B, S) or a batch) -> (f32 logits
    of the last position, caches): `Model.prefill`."""
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


def make_serve_step(model):
    """-> serve_step(params, batch, caches) -> (next tokens (B,) int32,
    caches): one `Model.decode_step` and the greedy choice at its last
    position, the step `generate` runs (captured as one CUDA graph on
    the card, as the reference jits it)."""
    def serve_step(params, batch, caches):
        logits, caches = model.decode_step(params, batch, caches)
        return greedy_tokens(logits[:, -1]), caches
    return serve_step
