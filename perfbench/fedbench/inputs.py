"""The inputs of a run, made from ``--seed`` on the run's device.

Weights: every leaf of the configuration's parameter tree, drawn from one
``torch.Generator`` on the device in a few large calls: one standard
normal draw for all the matrices (clipped at +-2, each leaf scaled by
``1 / sqrt(fan_in)``), one for the embedding (scale 0.02), one uniform
for the SSD time steps; norm scales and gains are ones, biases zeros,
``A_log = log(1..H)``.  The same seed gives the same bits again, so the
reference draws its copy after the program's state is freed.

Documents: client ``l`` of ``L`` holds ``docs_per_client[l]`` documents of
``seq_len + 1`` tokens, Zipf(``zipf_a``) over its own window of the
vocabulary (``[lo, lo + V/2)``, ``lo = l V / 2L``), so that the clients'
data differ as the federated experiments' do.  The sizes are the traffic
mix's; the seed picks only the values.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping

import torch

_ONES = ("scale", "beta_attn", "beta_ssm", "D")
_ZEROS = ("conv_b", "bias", "bq", "bk", "bv", "b_up", "b_down")


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 63)
    return g


def _walk(node, path=()):
    if isinstance(node, list):
        for i, v in enumerate(node):
            yield from _walk(v, path + (i,))
    elif isinstance(node, Mapping):
        for k in sorted(node):
            yield from _walk(node[k], path + (k,))
    else:
        yield path, node


def _rebuild(node, leaves, path=()):
    if isinstance(node, list):
        return [_rebuild(v, leaves, path + (i,)) for i, v in enumerate(node)]
    if isinstance(node, Mapping):
        return {k: _rebuild(v, leaves, path + (k,)) for k, v in node.items()}
    return leaves[path]


def make_weights(shapes: Mapping[str, Any], seed: int, device
                 ) -> Dict[str, Any]:
    """A weight tree shaped as ``shapes`` (a tree of tensors whose shapes
    are read, such as meta tensors), drawn as the module docstring says."""
    g = generator(seed, device)
    leaves: Dict[tuple, torch.Tensor] = {}
    dense, table, steps = [], None, []
    for path, t in _walk(shapes):
        name, shape = path[-1], tuple(t.shape)
        if name in _ONES:
            leaves[path] = torch.ones(shape, device=device)
        elif name in _ZEROS:
            leaves[path] = torch.zeros(shape, device=device)
        elif name == "A_log":
            leaves[path] = torch.log(torch.arange(
                1, shape[0] + 1, dtype=torch.float32, device=device))
        elif name == "dt_bias":
            steps.append((path, shape))
        elif path[0] == "embed":
            table = (path, shape)
        elif len(shape) >= 2:
            dense.append((path, shape))
        else:
            raise ValueError(f"no rule draws the weight {path} {shape}")
    total = sum(math.prod(s) for _, s in dense)
    buf = torch.randn(total, generator=g, device=device).clamp_(-2.0, 2.0)
    off = 0
    for path, shape in dense:
        n = math.prod(shape)
        leaves[path] = buf[off:off + n].view(shape) * shape[0] ** -0.5
        off += n
    del buf
    if table is not None:
        leaves[table[0]] = torch.randn(table[1], generator=g,
                                       device=device) * 0.02
    if steps:
        n = sum(math.prod(s) for _, s in steps)
        u = torch.rand(n, generator=g, device=device)
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        inv = dt + torch.log(-torch.expm1(-dt))       # inverse softplus
        off = 0
        for path, shape in steps:
            k = math.prod(shape)
            leaves[path] = inv[off:off + k].view(shape).clone()
            off += k
    return _rebuild(shapes, leaves)


def make_docs(traffic: Mapping[str, Any], vocab: int, seed: int, device
              ) -> List[torch.Tensor]:
    """Each client's documents, ``(n_l, seq_len + 1)`` int32 tokens."""
    g = generator(seed + 0x5EED, device)
    sizes = traffic["docs_per_client"]
    n_clients, width = len(sizes), traffic["seq_len"] + 1
    out = []
    for l, n in enumerate(sizes):
        lo = (l * vocab) // (2 * n_clients)
        hi = min(vocab, lo + max(vocab // 2, 2))
        ranks = torch.arange(1, hi - lo + 1, dtype=torch.float64,
                             device=device)
        p = ranks ** -float(traffic["zipf_a"])
        tok = torch.multinomial((p / p.sum()).float(), n * width,
                                replacement=True, generator=g) + lo
        out.append(tok.view(n, width).to(torch.int32))
    return out
