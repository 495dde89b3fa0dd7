"""Shared body of ``tests/test_torch_lm_positions_*.py``'s whole-model
cases: a left-padded batch (``positions = arange(S) - pad``) through the
port and the reference, split over files by architecture so that no file
runs long under xdist's ``--dist loadfile``."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.data import lm_data as jdata
from repro.models import transformer as jtfm
from repro_torch.models import transformer as ttfm
from repro_torch.optim import optimizers as toptim
from torch_lm_zoo_common import batch_j, batch_t, dev, model, pairs, t

PROMPT, STEPS = 24, 4


def left_pad_positions(b, s, pads):
    return np.stack([np.arange(s) - pads[i % len(pads)] for i in range(b)])


def check_left_padded_model(arch):
    """A batch with ``positions = arange(S) - pad`` (pads 0, 5 and 17; a
    VLM batch's patches and M-RoPE streams, hubert's frames) through the
    port and the reference: prefill logits and cache, then four decode
    steps (hubert: the encoder's forward), and ``train_loss`` with every
    gradient leaf, within 2e-4."""
    jc, tc, jp, tp = model(arch, seed=2)
    b = 3
    batch = jdata.synthetic_lm_batch(jc, b, PROMPT, seed=6)
    batch["positions"] = left_pad_positions(b, PROMPT, (0, 5, 17))
    devs = {}
    if not jc.encoder_only:
        toks = np.random.default_rng(8).integers(0, jc.vocab_size,
                                                 (b, STEPS))
        cut = {k: v for k, v in batch.items()
               if k not in ("labels", "loss_mask")}
        jl, jcache = jtfm.prefill(jp, jc, batch_j(cut), dtype=jnp.float32,
                                  max_len=PROMPT + STEPS)
        tl, tcache = ttfm.prefill(tp, tc, batch_t(cut), dtype=torch.float32,
                                  max_len=PROMPT + STEPS)
        devs["prefill"] = dev(tl, jl)
        for key in jcache:
            if key != "pos":
                devs[key] = dev(tcache[key], jcache[key])
        for i in range(STEPS):
            step = toks[:, i:i + 1]
            jl, jcache = jtfm.decode_step(jp, jc, jcache,
                                          jnp.asarray(step, jnp.int32),
                                          dtype=jnp.float32)
            tl, tcache = ttfm.decode_step(tp, tc, tcache, t(step),
                                          dtype=torch.float32)
            devs[f"decode{i}"] = dev(tl, jl)
    else:
        jl, _ = jtfm.forward_train(jp, jc, batch_j(batch), dtype=jnp.float32)
        tl, _ = ttfm.forward_train(tp, tc, batch_t(batch),
                                   dtype=torch.float32)
        devs["forward"] = dev(tl, jl)
    jloss, jg = jax.value_and_grad(
        lambda p: jtfm.train_loss(p, jc, batch_j(batch),
                                  dtype=jnp.float32))(jp)
    for leaf in toptim.tree_leaves(tp):
        leaf.requires_grad_(True)
    tloss = ttfm.train_loss(tp, tc, batch_t(batch), dtype=torch.float32)
    tloss.backward()
    gdevs = {path: dev(u.grad, w) for path, w, u in pairs(jg, tp)}
    worst = max(gdevs, key=gdevs.get)
    print(f"{arch} left-padded: {devs}; train_loss {tloss.item()} vs "
          f"{float(jloss)}, {len(gdevs)} gradient leaves, worst {worst} "
          f"{gdevs[worst]:.3e}")
    assert max(devs.values()) <= 2e-4
    assert abs(float(tloss) - float(jloss)) <= 2e-4 * abs(float(jloss))
    assert len(gdevs) == len(toptim.tree_leaves(tp))
    assert max(gdevs.values()) <= 2e-4
