"""Decode-path smoke CLI: build a tiny causal LM, serve it through the
continuous-batching decode stack, stream the generated tokens
(counterpart of paddle_tpu/tools/generate.py, with its flags).

    python -m paddle_tpu_torch.tools.generate --prompt "3 1 4 1 5" \
        --max-new-tokens 16 [--vocab 64] [--layers 2] [--d-model 32] \
        [--eos EOS_ID] [--seed N] [--metrics] [--cache-dir DIR] \
        [--temperature T] [--top-k K] [--top-p P] [--sample-seed N] \
        [--draft-model LAYERS:D_MODEL] [--speculate-k K] \
        [--prefix-cache] [--kv-dtype int8] [--device cuda|cpu]

The model is freshly initialized (``--seed N`` re-draws every param
from that seed, as the JAX CLI does, so the same seed generates the same
tokens in either package; the default keeps initializer values) — the
point is a one-command end-to-end drive of ``paddle_tpu_torch.decoding``
on the card (``--device cuda``, the default; ``cpu`` runs on the host):
the rewrite derives the prefill/decode pair, the engine captures its
bucket set as CUDA graphs, the session streams tokens as they are
produced, and the process exits with the engine's graph count printed
(``--metrics`` adds the full serving metrics report). ``--cache-dir``
sets the ``compile_cache_dir`` flag (the compile cache: tuned kernel
configs and capture fingerprints live under DIR).

Serving legs: ``--temperature/--top-k/--top-p`` switch
the session to the seeded sampling head (``--sample-seed`` pins the
stream; temperature 0 stays exact greedy), ``--draft-model 1:16`` builds
a LAYERSxD_MODEL draft and decodes speculatively (``--speculate-k``
tokens per verify step, acceptance rate in ``--metrics``),
``--prefix-cache`` shares prompt-prefix blocks, and ``--kv-dtype int8``
stores the KV pools quantized.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.generate",
        description=__doc__.splitlines()[0])
    parser.add_argument("--prompt", default="3 1 4 1 5",
                        help="whitespace-separated token ids")
    parser.add_argument("--max-new-tokens", type=int, default=16)
    parser.add_argument("--vocab", type=int, default=64)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--d-model", type=int, default=32)
    parser.add_argument("--heads", type=int, default=2)
    parser.add_argument("--eos", type=int, default=None)
    parser.add_argument("--seed", type=int, default=None,
                        help="re-draw all params from this seed "
                             "(default: keep initializer values)")
    parser.add_argument("--block-size", type=int, default=8)
    parser.add_argument("--num-blocks", type=int, default=32)
    parser.add_argument("--max-blocks-per-seq", type=int, default=8)
    parser.add_argument("--temperature", type=float, default=0.0,
                        help="sampling temperature (0 = greedy)")
    parser.add_argument("--top-k", type=int, default=0,
                        help="keep only the k most-probable tokens "
                             "(0 = off)")
    parser.add_argument("--top-p", type=float, default=1.0,
                        help="nucleus sampling mass (1.0 = off)")
    parser.add_argument("--sample-seed", type=int, default=0,
                        help="RNG seed of the sampled stream (seeded "
                             "streams are bit-reproducible)")
    parser.add_argument("--draft-model", default=None,
                        metavar="LAYERS:D_MODEL",
                        help="build a LAYERSxD_MODEL draft of the same "
                             "vocab and decode speculatively, e.g. 1:16")
    parser.add_argument("--speculate-k", type=int, default=4,
                        help="draft tokens per verify step "
                             "(with --draft-model)")
    parser.add_argument("--prefix-cache", action="store_true",
                        help="share prompt-prefix KV blocks across "
                             "requests (content-hash, refcounted)")
    parser.add_argument("--kv-dtype", choices=["int8"], default=None,
                        help="store the KV pools quantized")
    parser.add_argument("--metrics", action="store_true",
                        help="print the serving metrics report on exit")
    parser.add_argument("--cache-dir", default=None,
                        help="compile cache directory")
    parser.add_argument("--device", choices=["cuda", "cpu"],
                        default="cuda",
                        help="run on the card (default) or the host")
    args = parser.parse_args(argv)

    prompt = [int(t) for t in args.prompt.split()]
    if not prompt:
        print("empty --prompt", file=sys.stderr)
        return 2
    if max(prompt) >= args.vocab or min(prompt) < 0:
        print("prompt ids must be in [0, --vocab)", file=sys.stderr)
        return 2
    draft_spec = None
    if args.draft_model is not None:
        try:
            d_layers, d_model = (int(x) for x in
                                 args.draft_model.split(":"))
        except ValueError:
            print("--draft-model wants LAYERS:D_MODEL (e.g. 1:16)",
                  file=sys.stderr)
            return 2
        draft_spec = (d_layers, d_model)

    if args.cache_dir:
        from ..core import flags

        flags.set_flags({"compile_cache_dir": args.cache_dir})

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.convert import seeded_state
    from paddle_tpu_torch.decoding import (CacheConfig, DecodingConfig,
                                           SamplingParams, serve_decoding)
    from paddle_tpu_torch.models.causal_lm import causal_lm

    place = fluid.CUDAPlace(0) if args.device == "cuda" \
        else fluid.CPUPlace()

    def build_model(n_layer, d_model, seed):
        main_p, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), \
                fluid.program_guard(main_p, startup):
            tokens, logits = causal_lm(
                vocab_size=args.vocab, n_layer=n_layer,
                n_head=args.heads, d_model=d_model,
                d_inner_hid=2 * d_model)
        scope = fluid.Scope()
        fluid.Executor(place).run(startup, scope=scope)
        if seed is not None:
            # re-draw every parameter from the seeded RNG (the JAX
            # CLI's order and draws) so different seeds generate
            # different streams and a seed is the same model in either
            # package
            seeded_state(main_p, scope, place, seed, 0.05)
        return main_p, scope, logits

    main_p, scope, logits = build_model(args.layers, args.d_model,
                                        args.seed)
    sampling_on = args.temperature > 0 or args.top_k > 0 \
        or args.top_p < 1.0
    config = DecodingConfig(
        cache=CacheConfig(num_blocks=args.num_blocks,
                          block_size=args.block_size,
                          max_blocks_per_seq=args.max_blocks_per_seq,
                          kv_dtype=args.kv_dtype,
                          prefix_cache=args.prefix_cache),
        max_new_tokens=args.max_new_tokens,
        sampling=sampling_on,
        speculate_k=args.speculate_k if draft_spec else 0)
    draft_kw = {}
    if draft_spec:
        d_main, d_scope, d_logits = build_model(
            draft_spec[0], draft_spec[1],
            (args.seed or 0) + 1)
        draft_kw = dict(draft_program=d_main,
                        draft_logits_name=d_logits.name,
                        draft_scope=d_scope)
    session = serve_decoding(main_p, "tokens", logits.name, scope=scope,
                             config=config, place=place, **draft_kw)
    try:
        print(f"prompt: {prompt}")
        sys.stdout.write("tokens:")
        sys.stdout.flush()

        def stream(tok: int) -> None:
            sys.stdout.write(f" {tok}")
            sys.stdout.flush()

        sampling = None
        if sampling_on:
            sampling = SamplingParams(temperature=args.temperature,
                                      top_k=args.top_k,
                                      top_p=args.top_p,
                                      seed=args.sample_seed)
        out = session.generate(prompt,
                               max_new_tokens=args.max_new_tokens,
                               eos_id=args.eos, on_token=stream,
                               sampling=sampling)
        print()
        print(f"generated {len(out)} token(s); "
              f"graphs={session.engine.num_compiled}")
        if draft_spec:
            rep = session.metrics.report()
            print(f"speculative acceptance rate: "
                  f"{rep['spec_acceptance_rate']}")
        if args.metrics:
            print(session.metrics.render())
    finally:
        session.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
