"""End-to-end driver of the PyTorch port: federated LM fine-tuning
through the Federation facade, with the flags of
``examples/federated_lm_training.py`` and ``--device``.

Trains a reduced registry architecture (phi3 family by default) under the
full federated machinery: a synthetic non-IID token corpus pooled and
re-partitioned with a ``dirichlet`` label-skew partitioner, delta
messages with ``topk`` sparsification and error feedback, the batched
cohort path (``torch.func.vmap`` over the clients) and the Eq. (2)/(3)
aggregation: the ``lm_dirichlet_topk`` registry scenario.  On a CUDA
device the attention and SSM cores run kernels B5 and B6 and their
backward kernels, the combine B2 and the top-k B4.

Run:  PYTHONPATH=src python examples/torch_federated_lm_training.py \\
          --rounds 40 --arch phi3-mini-3.8b --width 256 --device cpu
"""
import argparse
import time

from repro_torch.api.federation import Federation
from repro_torch.api.registry import scenario_spec
from repro_torch.api.spec import spec_replace


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--docs", type=int, default=96)
    ap.add_argument("--layers", type=int, default=0,
                    help="0 = the arch's reduced() depth")
    ap.add_argument("--width", type=int, default=0,
                    help="d_model override (multiple of 64); 0 = reduced")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--alpha", type=float, default=0.3,
                    help="dirichlet label-skew concentration")
    ap.add_argument("--topk", type=float, default=0.25,
                    help="fraction of delta coordinates kept per message")
    ap.add_argument("--exec-mode", default="vmap",
                    choices=("loop", "vmap"))
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)

    spec = spec_replace(scenario_spec("lm_dirichlet_topk"), {
        "model.arch": args.arch, "model.vocab": args.vocab,
        "model.seq_len": args.seq, "model.layers": args.layers,
        "model.width": args.width,
        "data.num_clients": args.clients, "data.docs_per_node": args.docs,
        "data.val_docs_per_node": max(args.docs // 4, 8),
        "data.partition": f"dirichlet({args.alpha})",
        "schedule.rounds": args.rounds,
        "transforms.compression_topk": args.topk,
        "execution.batch_size": args.batch,
        "execution.learning_rate": args.lr,
        "execution.exec_mode": args.exec_mode,
    })

    fed = Federation.from_spec(spec, device=args.device)
    cfg = fed.model_cfg
    print(f"model: {args.arch} {cfg.num_layers}L d={cfg.d_model} "
          f"(~{cfg.num_params()/1e6:.1f}M params), {args.clients} clients, "
          f"dirichlet({args.alpha}) partition, "
          f"topk({args.topk}) deltas, exec={args.exec_mode}, "
          f"device={fed.device}")

    t0 = time.time()

    @fed.on_round_end
    def _log(rec):
        if rec["round"] % 5 == 0:
            print(f"[round {rec['round']:3d}] loss={rec['loss']:.4f} "
                  f"K={rec['participants']}")

    fed.run()
    losses = [h["loss"] for h in fed.history]
    metrics = fed.evaluate()
    print(f"\nloss {losses[0]:.3f} -> {losses[-1]:.3f} in "
          f"{time.time()-t0:.1f}s; held-out xent/token="
          f"{metrics['heldout_xent_per_token']:.3f} "
          f"ppl={metrics['heldout_perplexity']:.1f}")
    if not min(losses[-5:]) < losses[0]:
        raise SystemExit("training should reduce loss")


if __name__ == "__main__":
    main()
