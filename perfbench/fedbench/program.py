"""The system under test, driven through its entry point.

A run builds one ``repro_torch.api.Federation`` with
``Federation.from_spec(spec, device=..., clients=..., loss_fn=...,
loss_sum_fn=..., init_params=...)``: the registry scenario the traffic mix
names, sized by the mix, over the configuration's model (the registry's
fp32 bundle at the configuration's sizes and depth), the clients holding
the documents the benchmark made, from the weights it made.  Each timed
call is ``Federation.step()``.  From the program the harness reads only
the kernel modules' call counters.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, List, Mapping

import torch

# (module of repro_torch.kernels, counter) -> family
COUNTERS = {
    ("fed_aggregate", "launches"): "fed_weighted_sum",
    ("fed_aggregate", "dp_secure_launches"): "fed_dp_secure",
    ("fed_aggregate", "topk_ef_launches"): "fed_topk_ef",
    ("topic_decoder", "launches"): "topic_decoder",
    ("flash_attention", "launches"): "flash_attention",
    ("flash_attention", "bwd_launches"): "flash_attention_bwd",
    ("ssd_scan", "launches"): "ssd_scan",
    ("ssd_scan", "bwd_launches"): "ssd_scan_bwd",
}

_TOP = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
        "d_ff", "vocab_size", "sliding_window", "rope_theta", "norm_eps",
        "tie_embeddings", "activation")
_SSM = {"ssm_state_dim": "state_dim", "ssm_head_dim": "head_dim",
        "ssm_expand": "expand", "ssm_chunk_size": "chunk_size",
        "ssm_conv_width": "conv_width"}


def port_config(cfg: Mapping[str, Any]):
    """The program's ``ModelConfig`` of the architecture, at the sizes the
    configuration file states (the file holds the configuration as run)."""
    from repro_torch.configs import get_config
    base = get_config(cfg["arch"])
    if base.kind != cfg["kind"]:
        raise ValueError(f"{cfg['name']}: the program's {cfg['arch']} is "
                         f"{base.kind!r}, the file says {cfg['kind']!r}")
    ssm = dataclasses.replace(base.ssm, **{f: cfg[k] for k, f in _SSM.items()
                                           if k in cfg})
    top = {k: cfg[k] for k in _TOP if k in cfg}
    return dataclasses.replace(base, ssm=ssm, **top)


def param_shapes(cfg: Mapping[str, Any]):
    """The parameter tree of the configuration as meta tensors."""
    from repro_torch.models import transformer
    return transformer.init_param_shapes(port_config(cfg), device="meta")


def build(cfg: Mapping[str, Any], traffic: Mapping[str, Any],
          weights: Mapping[str, Any], docs: List[torch.Tensor],
          exec_seed: int, device):
    from repro_torch.api import Federation, scenario_spec, spec_replace
    from repro_torch.core.engine import ClientState
    from repro_torch.models.registry import build_model
    model = port_config(cfg)
    bundle = build_model(model, dtype=getattr(torch, cfg["dtype"]))
    spec = spec_replace(scenario_spec(traffic["scenario"]), {
        "model.arch": cfg["arch"], "model.vocab": cfg["vocab_size"],
        "model.seq_len": traffic["seq_len"],
        "data.num_clients": len(docs),
        "data.docs_per_node": max(d.shape[0] for d in docs),
        "execution.exec_mode": traffic["exec_mode"],
        "execution.batch_size": traffic["batch_size"],
        "execution.learning_rate": traffic["learning_rate"],
        "execution.seed": exec_seed,
        "schedule.local_epochs": traffic["local_epochs"]})
    topk = "topk" in spec.transforms.names
    if topk != bool(traffic.get("topk_frac")) or (
            topk and spec.transforms.compression_topk
            != traffic["topk_frac"]):
        raise ValueError(f"scenario {traffic['scenario']!r} transforms "
                         f"{spec.transforms.names} (top-k "
                         f"{spec.transforms.compression_topk}) differ from "
                         f"the traffic mix's topk_frac "
                         f"{traffic.get('topk_frac')}")
    if spec.transforms.names not in ((), ("topk",)) \
            or spec.server_opt.name != "fedavg" or spec.server_opt.lr != 1.0 \
            or spec.schedule.clients_per_round not in (0, len(docs)) \
            or spec.schedule.straggler_prob:
        raise ValueError(f"scenario {traffic['scenario']!r} runs work the "
                         "plain reference does not model")
    clients = [ClientState(data={
        "tokens": d[:, :-1].contiguous(), "labels": d[:, 1:].contiguous(),
        "loss_mask": torch.ones(d.shape[0], d.shape[1] - 1,
                                device=d.device)}, num_docs=d.shape[0])
        for d in docs]
    return Federation.from_spec(spec, device=device, clients=clients,
                                loss_fn=bundle.loss,
                                loss_sum_fn=bundle.loss_sum,
                                init_params=weights)


def read_counters() -> Dict[str, int]:
    out = {}
    for (mod, attr), family in COUNTERS.items():
        m = importlib.import_module(f"repro_torch.kernels.{mod}")
        out[family] = int(getattr(m, attr))
    return out

