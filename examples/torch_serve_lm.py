"""Batched serving demo on the PyTorch/CUDA port: train a tiny model briefly
so generation is non-degenerate, then serve batched greedy continuations
through the model's `decode_step`.

    PYTHONPATH=src python examples/torch_serve_lm.py                # on the card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

Training runs `impl="ref"` (plain attention) and decoding attends over its
cache in plain torch, so this example launches no kernel of the port.
"""
import argparse
import dataclasses
import time

from repro_torch.configs import ARCHS
from repro_torch.graph import resolve_device
from repro_torch.models import build
from repro_torch.serve import ServeEngine
from repro_torch.train import OptimizerConfig, init_state, make_train_step
from repro_torch.train.data import DataConfig, batch_at


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    t0 = time.perf_counter()
    cfg = dataclasses.replace(ARCHS["qwen2.5-3b"].smoke(), n_layers=2, vocab=256)
    model = build(cfg, device=args.device, seed=0)
    state = init_state(model)
    oc = OptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    step = make_train_step(model, oc, impl="ref")
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, structure=4)
    for i in range(60):
        state, m = step(state, batch_at(dc, i, device=args.device))
    loss = float(m["loss"])
    print(f"pre-trained tiny model to loss {loss:.3f} (periodic n-grams)")

    engine = ServeEngine(model, max_len=48, batch_size=4)
    # prompts drawn from the training distribution (period-4 n-grams)
    base = batch_at(dc, 999, device="cpu")["tokens"][:4, :8].numpy()
    res = engine.generate(base, new_tokens=12)
    for i, seq in enumerate(res.tokens):
        prompt, gen = seq[:8].tolist(), seq[8:].tolist()
        print(f"req{i}: prompt={prompt} → generated={gen}")
    # a learned period-4 model should repeat the prompt's cycle
    period_hits = sum(int(seq[8 + j] == seq[8 + j - 4])
                      for seq in res.tokens for j in range(4, 12))
    print(f"period-4 consistency: {period_hits}/{4*8} generated tokens")
    return {"loss": loss, "tokens": res.tokens, "period_hits": period_hits,
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
