"""The production pipeline on the port: LM embeddings -> the paper's clustering.

    PYTHONPATH=src python examples/torch_embed_and_cluster.py           # on the card
    PYTHONPATH=src python examples/torch_embed_and_cluster.py --cpu     # on the CPU

The same demo as ``embed_and_cluster.py``, on ``repro_torch``. Documents of
the synthetic topic corpus are rendered as token sequences, embedded with a
reduced model of the zoo (random weights from a seed) through
``ServeEngine.embed`` (mean-pooled hidden states), and clustered with
Buckshot. It prints purity and NMI of LM embeddings against raw tf-idf on
the same documents: the framework's two document representations. On the card Buckshot runs on the port's CUDA kernels
(``sim_best_edge``, ``label_stats``, ``assign_stats``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def quality(assignment: torch.Tensor, truth: np.ndarray, k: int) -> tuple[float, float]:
    """(purity, NMI) of an assignment against the topic labels."""
    from repro_torch.core import metrics

    t = torch.from_numpy(truth).to(assignment.device)
    return float(metrics.purity(assignment, t, k, k)), float(metrics.nmi(assignment, t, k, k))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from repro_torch.common import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core import buckshot
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import ServeEngine, embed_documents
    from repro_torch.text import pipeline, synth

    dev = resolve_device("cpu" if args.cpu else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    corpus = synth.make_corpus(args.n, vocab=512, n_topics=args.k, seed=1)

    # ---- representation 1: tf-idf (the paper's)
    x_tfidf, truth = pipeline.prepare_local(corpus, dev)
    bs = buckshot(x_tfidf, args.k, torch.Generator().manual_seed(0), kmeans_iters=2)
    pur, nmi = quality(bs.kmeans.assignment, truth, args.k)
    print(f"tf-idf   + Buckshot: purity={pur:.3f} nmi={nmi:.3f}")

    # ---- representation 2: LM embeddings (mean-pooled hidden states)
    cfg = get_config(args.arch, reduced=True)
    params = get_model(cfg).init_params(torch.Generator(device=dev).manual_seed(1), dev)
    engine = ServeEngine(cfg=cfg, params=params, device=dev)
    toks = synth.tokens_from_counts(corpus.counts, cfg.vocab, args.seq, seed=2)
    x_lm = embed_documents(engine, toks)
    bs2 = buckshot(x_lm, args.k, torch.Generator().manual_seed(0), kmeans_iters=2)
    pur2, nmi2 = quality(bs2.kmeans.assignment, truth, args.k)
    print(f"{args.arch:8s} + Buckshot: purity={pur2:.3f} nmi={nmi2:.3f} "
          f"(untrained reduced model, random weights — structure only)")


if __name__ == "__main__":
    main()
