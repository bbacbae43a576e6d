"""zamba2-7b's float32 gradient in both packages against the float64 oracle,
layer by layer (ROADMAP.md §3).

The reduced zamba2-7b of ``tests/torch_port/test_torch_training.py::
test_loss_and_gradients_match_jax`` (two groups of two Mamba-2 layers and
the shared attention block), its weights from ``--seed`` and its batch
from ``--seed + 1``, run as a chain of layers in each package in float32
and in the JAX package at float64 with its float32 islands read as
float64 (the test's oracle).  Prints:

* chained: each layer boundary's output and the loss's gradient there
  (every layer run on its own package's previous output), as the distance
  from the oracle over the oracle's largest magnitude;
* local: each layer fed the oracle's input and upstream gradient rounded
  to float32, so that only its own rounding shows;
* mixed: the chain with chosen layers taken from the other package (the
  rows name them), the final output's and the embedding rows' gradient's
  distances;
* leaves: the whole model's gradient leaves (as the test computes them),
  the worst leaf and on how many leaves the port is further than the JAX
  package.

Run from the repository root (JAX on the CPU; about 40 s):

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/zamba2_oracle_layers.py --seed 0
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"
                       / "torch_port"))
import test_torch_training as T  # noqa: E402
from repro.models import blocks as jblk  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.models import blocks as pblk  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.carry import params_from_reference  # noqa: E402
from repro_torch.models.layers import next_token_loss, rms_norm  # noqa: E402
from repro_torch.training.loop import loss_and_grads  # noqa: E402
from repro_torch.utils.tree import tree_paths_and_leaves  # noqa: E402


def rel(a, oracle) -> float:
    return float(np.abs(np.asarray(a, np.float64) - oracle).max()
                 / (np.abs(oracle).max() + 1e-300))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    seed = ap.parse_args(argv).seed
    torch.set_num_threads(4)
    jcfg, pcfg, jm, value_and_grad = T.reference_loss("zamba2-7b")
    jp = T.reference_params(jm, jcfg, seed)
    batch = T.make_batch(jcfg, seed + 1)
    tokens = jnp.asarray(batch["tokens"])
    g, per = jcfg.n_layers // jcfg.attn_every, jcfg.attn_every
    labels = [f"g{gi}.{'mamba%d' % li if li < per else 'shared'}"
              for gi in range(g) for li in range(per + 1)]

    def jax_fns(cfg, params):
        fns = []
        for gi in range(g):
            for li in range(per):
                p_l = jax.tree.map(lambda a, gi=gi, li=li: a[gi, li],
                                   params["groups"])
                fns.append(lambda x, p_l=p_l: jblk.mamba_block_parallel(
                    p_l, x, cfg)[0])
            lora = jax.tree.map(lambda a, gi=gi: a[gi],
                                params["shared"]["lora"])
            fns.append(lambda x, lora=lora: jblk.shared_attn_parallel(
                params["shared"], lora, x, cfg)[0])
        return fns

    def jax_head(cfg, params):
        def head(x):
            xn = jlayers.rms_norm(x, params["final_norm"], cfg.norm_eps)
            return jlayers.next_token_loss(
                jnp.einsum("...d,dv->...v", xn, params["lm_head"]), tokens)
        return head

    def jax_chain(cfg, params):
        x = params["embed"][tokens]
        outs, vjps = [x], []
        for fn in jax_fns(cfg, params):
            x, vjp = jax.vjp(fn, x)
            outs.append(x)
            vjps.append(vjp)
        gx = jax.grad(jax_head(cfg, params))(x)
        grads = [gx]
        for vjp in reversed(vjps):
            gx = vjp(gx)[0]
            grads.append(gx)
        return ([np.asarray(o, np.float64) for o in outs],
                [np.asarray(d, np.float64) for d in grads[::-1]])

    jparams = jax.tree.map(jnp.asarray, jp)
    jouts, jgrads = jax_chain(jcfg, jparams)
    as64 = lambda a: (np.asarray(a, np.float64)  # noqa: E731
                      if a.dtype.kind == "f" else a)
    with T.float64_reference():
        oouts, ograds = jax_chain(
            dataclasses.replace(jcfg, dtype="float64"),
            jax.tree.map(lambda a: jnp.asarray(as64(a)), jp))

    pp = params_from_reference(jp)
    ttokens = torch.from_numpy(batch["tokens"]).long()
    pfns = []
    for gi in range(g):
        for li in range(per):
            pfns.append(lambda x, p_l=pp["groups"][gi][li]:
                        pblk.mamba_block_parallel(p_l, x, pcfg)[0])
        pfns.append(lambda x, gi=gi: pblk.shared_attn_parallel(
            pp["shared"], pp["shared"]["lora"][gi], x, pcfg)[0])

    def port_head(x):
        return next_token_loss(
            rms_norm(x, pp["final_norm"], pcfg.norm_eps) @ pp["lm_head"],
            ttokens)

    x = torch.nn.functional.embedding(ttokens, pp["embed"]).requires_grad_(
        True)
    pouts = [x]
    for fn in pfns:
        pouts.append(fn(pouts[-1]))
    for o in pouts:
        o.retain_grad()
    port_head(pouts[-1]).backward()
    print(f"zamba2-7b, weights seed {seed}: distance from the float64 oracle "
          "over its largest magnitude")
    print(f"\nchained {'':8s} {'out port':>10s} {'out jax':>10s} "
          f"{'grad port':>10s} {'grad jax':>10s}")
    for i, lab in enumerate(["embed", *labels]):
        print(f"{lab:16s} {rel(pouts[i].detach(), oouts[i]):10.3e} "
              f"{rel(jouts[i], oouts[i]):10.3e} "
              f"{rel(pouts[i].grad, ograds[i]):10.3e} "
              f"{rel(jgrads[i], ograds[i]):10.3e}")

    jfns = jax_fns(jcfg, jparams)
    print(f"\nlocal {'':10s} {'out port':>10s} {'out jax':>10s} "
          f"{'din port':>10s} {'din jax':>10s}")
    for i, (lab, jf, pf) in enumerate(zip(labels, jfns, pfns)):
        xin = oouts[i].astype(np.float32)
        gup = ograds[i + 1].astype(np.float32)
        jo, jv = jax.vjp(jf, jnp.asarray(xin))
        tx = torch.from_numpy(xin).requires_grad_(True)
        to = pf(tx)
        (td,) = torch.autograd.grad(to, tx, torch.from_numpy(gup))
        print(f"{lab:16s} {rel(to.detach(), oouts[i + 1]):10.3e} "
              f"{rel(jo, oouts[i + 1]):10.3e} {rel(td, ograds[i]):10.3e} "
              f"{rel(jv(jnp.asarray(gup))[0], ograds[i]):10.3e}")

    def step(pkg, i, x):
        if pkg == "j":
            y, vjp = jax.vjp(jfns[i], jnp.asarray(x))
            return np.asarray(y), lambda d: np.asarray(vjp(jnp.asarray(d))[0])
        tx = torch.from_numpy(np.array(x)).requires_grad_(True)
        ty = pfns[i](tx)
        return ty.detach().numpy(), lambda d: torch.autograd.grad(
            ty, tx, torch.from_numpy(np.array(d)), retain_graph=True)[0].numpy()

    def mixed(choice):
        x, vjps = oouts[0].astype(np.float32), []
        for i, c in enumerate(choice):
            x, v = step(c, i, x)
            vjps.append(v)
        tx = torch.from_numpy(np.array(x)).requires_grad_(True)
        d = torch.autograd.grad(port_head(tx), tx)[0].numpy()
        for v in reversed(vjps):
            d = v(d)
        return rel(x, oouts[-1]), rel(d, ograds[0])

    print(f"\nmixed (the port's head) {'':2s} {'x_final':>10s} "
          f"{'d embed rows':>12s}")
    n = len(labels)
    mamba = [i for i, lab in enumerate(labels) if "mamba" in lab]
    cases = [("all port", set()), ("all jax", set(range(n))),
             ("the Mamba-2 layers jax", set(mamba)),
             ("the shared blocks jax", set(range(n)) - set(mamba)),
             *((f"{labels[i]} jax", {i}) for i in range(n))]
    for label, take in cases:
        out, d = mixed("".join("j" if i in take else "p" for i in range(n)))
        print(f"{label:26s} {out:10.3e} {d:12.3e}")

    jl, jg = value_and_grad(jp, T.to_jax(batch))
    ref = params_from_reference(jax.device_get(jg))
    oracle = T.float64_oracle(jcfg, jp, batch)
    _, grads = loss_and_grads(build_model(pcfg), T.unfrozen(jp),
                              T.to_torch(batch))
    names = [name for name, _ in tree_paths_and_leaves(ref)]
    d_jax, d_port = T.oracle_dist(ref, oracle), T.oracle_dist(grads, oracle)
    for label, d in (("jax", d_jax), ("port", d_port)):
        i = int(np.argmax(d))
        print(f"\nleaves, {label}: worst {d[i]:.3e} ({names[i]}); embed "
              f"{d[names.index('embed')]:.3e}", end="")
    print(f"\nthe port further from the oracle than the JAX package on "
          f"{sum(a > b for a, b in zip(d_port, d_jax))} of {len(d_port)} "
          "leaves")


if __name__ == "__main__":
    main()
