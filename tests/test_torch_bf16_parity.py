"""bf16 training of the Mamba2, MoE and embedding-input families against the
JAX package on the CPU: the loss and every gradient leaf of
``loss_and_grads`` on bf16 weights against ``jax.value_and_grad`` of the
JAX model's loss, on the same bf16 init and batch (the smoke configs and
``_batch`` of ``test_torch_training.py``).

The two packages round in other places where the families' own forms
differ, so these hold the port at limits taken from JAX's own gap:
"JAX's gap" on a leaf is rms(JAX bf16 - JAX fp32) / rms(JAX fp32), from
the fp32 init of the same seed, computed here and never written down.

- llava-next-34b: its fp32 embeddings run every block in fp32 in both
  packages, so it is held as hubert-xlarge is (the loss at LOSS_RTOL, each
  leaf within 2^-8 of its rms).
- mamba2-370m: JAX's ``ssd_chunked`` takes its cumulative sum of dA,
  exp(segsum) and einsums in bf16; the port's plain path is the token
  recurrence with an fp32 state (``kernels/ref.py``), as is the kernel on
  the card.  Each leaf within max(5e-2, 1.25 x JAX's gap), the loss at
  2e-4, and the port's own bf16-vs-fp32 gap at most 1.25 x JAX's + 1e-2 on
  every leaf: the port is no further from fp32 than JAX is.
- deepseek-moe-16b, mixtral-8x22b, jamba-1.5-large-398b: one ulp of the
  attention or the norm upstream flips a near tie of the router, and one
  token's top-k set then differs.  Pinned (the port's routing given JAX's
  bf16 top-k choices from the test side, the gates gathered from the
  port's own probabilities), each leaf within max(5e-2, 1.25 x JAX's gap)
  and the loss at 5e-4.  Unpinned (the port's own routing), the loss at
  1.5e-3 and at most 2 tokens of 64 per MoE sublayer whose top-k set
  differs from JAX's bf16 one.

``pytest -s`` prints the readings.  Each arch's JAX runs (fp32 and bf16)
are computed once and shared by its pinned and unpinned checks.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.training.train_loop import (  # noqa: E402
    loss_and_grads,
    to_batch,
)
from test_torch_training import (  # noqa: E402
    LOSS_RTOL,
    _batch,
    _flat_np,
    _jax_init,
    _rms,
)

LEAF_FLOOR = 5e-2         # a leaf's limit is max(LEAF_FLOOR, GAP_FACTOR x gap)
GAP_FACTOR = 1.25
OWN_GAP_SLACK = 1e-2      # mamba2-370m: port gap <= GAP_FACTOR x JAX's + this
MOE_ARCHS = ("deepseek-moe-16b", "mixtral-8x22b", "jamba-1.5-large-398b")
PINNED_LOSS_RTOL = 5e-4
UNPINNED_LOSS_RTOL = 1.5e-3
MAX_FLIPPED_TOKENS = 2    # of 64 per MoE sublayer, unpinned
CASES = ([("llava-next-34b", "plain"), ("mamba2-370m", "plain")]
         + [(a, r) for a in MOE_ARCHS for r in ("pinned", "unpinned")])


def _top_k(logits, K: int):
    """JAX's top-k choices of the router's logits, as ``_route_group``
    takes them (of the softmax)."""
    return jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)[1]


@functools.lru_cache(maxsize=None)
def _jax_runs(arch: str) -> dict:
    """JAX's loss and gradients in fp32 and in bf16 (the same seed), and
    its bf16 top-k choices [G, Tg, K] of every MoE call, in call order."""
    cfg = jax_smoke(arch)
    batch = jax.tree.map(jnp.asarray, _batch(get_smoke_config(arch)))
    out = {}
    for name, dtype in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        params, _ = _jax_init(cfg, dtype=dtype)
        choices = []
        original = jax_moe.moe_forward

        def recording(p, m, x, group_size=512, original=original,
                      choices=choices):
            B, S, d = x.shape
            tg = jax_moe._group_tokens(B * S, S, group_size)
            xg = x.reshape(B * S // tg, tg, d).astype(jnp.float32)
            logits = jnp.einsum("gtd,de->gte", xg, p["router"])
            jax.debug.callback(lambda i: choices.append(np.array(i)),
                               _top_k(logits, m.num_experts_per_tok),
                               ordered=True)
            return original(p, m, x, group_size)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_moe, "moe_forward", recording)
            (loss, _), grads = jax.jit(jax.value_and_grad(
                JaxModel(cfg).loss, has_aux=True))(params, batch)
            jax.effects_barrier()
        out[name] = (float(loss), _flat_np(jax.tree.map(np.asarray, grads)))
        out[f"{name}_choices"] = choices
    return out


def _routing(pinned, seen: list):
    """A test copy of the port's ``moe._route_group`` that records its own
    top-k choices in ``seen`` and, with ``pinned`` (a list of [G, Tg, K]
    arrays in call order), routes by those choices instead, the gates
    gathered from its own probabilities."""
    def route(xf, router, m, C):
        G, T, _ = xf.shape
        E, K = m.num_experts, m.num_experts_per_tok
        logits = xf.float() @ router.float()
        probs = torch.softmax(logits, dim=-1)
        gate, expert_idx = torch.topk(probs, K, dim=-1)
        seen.append(expert_idx.numpy().copy())
        if pinned is not None:
            expert_idx = torch.from_numpy(pinned[len(seen) - 1]).long()
            gate = probs.gather(-1, expert_idx)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

        choice_oh = F.one_hot(expert_idx, E).float()
        flat_oh = choice_oh.reshape(G, T * K, E)
        pos_in_expert = torch.cumsum(flat_oh, dim=1) - flat_oh
        slot = (pos_in_expert * flat_oh).sum(-1).reshape(G, T, K)
        keep = (slot < C).float()
        slot_oh = F.one_hot(slot.clamp(0, C - 1).long(), C).float()
        slot_oh = slot_oh * keep[..., None]
        dispatch = torch.einsum("gtke,gtkc->gtec", choice_oh, slot_oh)
        combine = torch.einsum("gtke,gtkc->gtec",
                               choice_oh * gate[..., None], slot_oh)
        f = choice_oh.sum(2).mean(1)
        pbar = probs.mean(1)
        zsum = torch.logsumexp(logits, dim=-1).square().mean(-1)
        dropped = 1.0 - keep.mean((1, 2))
        return dispatch, combine, f, pbar, zsum, dropped

    return route


def _port_run(arch: str, dtype, pinned=None) -> tuple:
    """(loss, flat gradients, the port's own top-k choices per MoE call) of
    the port's ``loss_and_grads`` on the JAX init in ``dtype``."""
    cfg = get_smoke_config(arch)
    _, tparams = _jax_init(jax_smoke(arch), dtype=dtype)
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        if cfg.moe is not None:
            mp.setattr(port_moe, "_route_group", _routing(pinned, seen))
        (loss, _), grads = loss_and_grads(Model(cfg), tparams,
                                          to_batch(_batch(cfg), "cpu"))
    return float(loss), _flat_np(grads), seen


def _gaps(a: dict, b: dict) -> dict:
    """rms(a - b) / rms(b) of every leaf."""
    return {k: _rms(a[k] - b[k]) / max(_rms(b[k]), 1e-30) for k in b}


def test_routing_copy_is_the_ports_routing():
    """Unpinned, the test copy of ``_route_group`` gives what the port's
    own does, tensor for tensor."""
    m = get_smoke_config("mixtral-8x22b").moe
    rng = np.random.default_rng(0)
    xf = torch.from_numpy(rng.standard_normal((2, 32, 16)).astype(
        np.float32)).bfloat16()
    router = torch.from_numpy(rng.standard_normal((16, m.num_experts))
                              .astype(np.float32))
    C = port_moe.capacity_per_group(32, m)
    for got, want in zip(_routing(None, [])(xf, router, m, C),
                         port_moe._route_group(xf, router, m, C)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("arch,routing", CASES,
                         ids=[f"{a}-{r}" for a, r in CASES])
def test_bf16_family_matches_jax(arch, routing):
    jx = _jax_runs(arch)
    want_loss, want = jx["bf16"]
    jax_gap = _gaps(want, jx["fp32"][1])
    pinned = jx["bf16_choices"] if routing == "pinned" else None
    loss, got, seen = _port_run(arch, jnp.bfloat16, pinned)
    assert got.keys() == want.keys()
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    errs = {k: _rms(got[k] - want[k]) / max(_rms(want[k]), 1e-30)
            for k in want}
    worst = max(errs, key=errs.get)
    print(f"{arch} ({routing}): loss {loss_rel:.2e} relative; worst leaf "
          f"{worst} {errs[worst]:.3e} (JAX's gap {jax_gap[worst]:.3e})")

    if routing == "unpinned":
        flipped = [int(np.any(np.sort(a, -1) != np.sort(b, -1), -1).sum())
                   for a, b in zip(seen, jx["bf16_choices"])]
        print(f"  tokens whose top-k set differs from JAX's bf16 one, per "
              f"MoE sublayer: {flipped}")
        assert len(seen) == len(jx["bf16_choices"]) > 0
        assert max(flipped) <= MAX_FLIPPED_TOKENS, flipped
        assert loss_rel <= UNPINNED_LOSS_RTOL
        return
    if arch == "llava-next-34b":
        assert loss_rel <= LOSS_RTOL
        bad = {k: e for k, e in errs.items() if e > 2.0 ** -8}
        assert not bad, bad
        return
    if routing == "pinned":
        assert len(seen) == len(pinned) > 0
    assert loss_rel <= (2e-4 if arch == "mamba2-370m" else PINNED_LOSS_RTOL)
    bad = {k: (e, jax_gap[k]) for k, e in errs.items()
           if e > max(LEAF_FLOOR, GAP_FACTOR * jax_gap[k])}
    assert not bad, bad
    if arch == "mamba2-370m":
        _, own32, _ = _port_run(arch, jnp.float32)
        own_gap = _gaps(got, own32)
        print(f"  the port's own gap: worst {max(own_gap.values()):.3e}; "
              f"JAX's: worst {max(jax_gap.values()):.3e}")
        bad = {k: (own_gap[k], jax_gap[k]) for k in own_gap
               if own_gap[k] > GAP_FACTOR * jax_gap[k] + OWN_GAP_SLACK}
        assert not bad, bad
