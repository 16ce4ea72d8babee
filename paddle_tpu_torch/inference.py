"""Inference API: load an exported model and run it without the Program
(counterpart of paddle_tpu/inference.py; reference:
paddle/fluid/inference/api/paddle_inference_api.h:88 PaddlePredictor,
:117 NativeConfig, :148 CreatePaddlePredictor; api/api_impl.cc
NativePaddlePredictor).

The artifact is what ``io.save_inference_model`` writes: a
``torch.export`` program per batch bucket (``__model__.pt2``,
``__model__.b<N>.pt2``) and ``__params__.npz``. The predictor loads a
bucket's program when that bucket first runs, moves it to its device
(``torch.export.passes.move_to_device_pass``: the artifact does not
depend on where it was written), and holds the parameters on the device,
loaded once. Every kernel in the graph is a custom op, so the dispatcher
runs the hand-written kernels on a card and their plain versions on the
CPU.

On a card the first run of each bucket captures the program as a CUDA
graph over fixed buffers — the feeds packed into one pinned host buffer
and one device buffer (one non-blocking copy in), the fetches into one
device buffer and one pinned host buffer (one copy out), the parameters
where they lie — and every later run replays it: ``compile_count``
counts those captures, as the program backend's does. ``cache_hits``
stays 0: the predictor compiles nothing the compile cache could serve
(the cache keys the exports that write these files).
On the CPU (``use_gpu=False``) the program runs eagerly and nothing is
captured.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .core import dtype_utils
from .core.enforce import EnforceError, enforce

__all__ = ["EnforceError", "NativeConfig", "NativePredictor",
           "PaddleTensor", "create_paddle_predictor"]


class PaddleTensor:
    """reference: paddle_inference_api.h:45 PaddleTensor."""

    def __init__(self, data, name: str = ""):
        self.data = np.asarray(data)
        self.name = name

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype


class NativeConfig:
    """reference: paddle_inference_api.h:117 NativeConfig. ``use_gpu``
    (default on; ``use_tpu`` is the JAX package's name for it) runs on
    ``cuda:<device>`` and raises without a card; ``use_gpu=False`` runs
    on the CPU."""

    def __init__(self, model_dir: str = "", use_tpu: bool = True,
                 device: int = 0, model_filename: Optional[str] = None,
                 params_filename: Optional[str] = None,
                 use_gpu: Optional[bool] = None):
        self.model_dir = model_dir
        self.use_gpu = use_tpu if use_gpu is None else use_gpu
        self.use_tpu = self.use_gpu
        self.device = device
        self.model_filename = model_filename
        self.params_filename = params_filename


class _BucketGraph:
    """One bucket's program captured as a CUDA graph over fixed buffers
    (the packing of ``executor._CapturedRun``). The first call runs the
    program eagerly on the capture stream (lazy initializations cannot
    be captured), captures it, then replays like every later call."""

    def __init__(self, module, feed_specs, params, device, stream):
        from .executor import _packed

        self.module, self.params = module, params
        self.device, self.stream = device, stream
        self.host_in, self.host_feeds = _packed(feed_specs, "cpu", pin=True)
        self.dev_in, self.dev_feeds = _packed(feed_specs, device, pin=False)
        self.graph = None

    def _capture(self) -> None:
        from .executor import _packed, capture_graph

        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            outs = self.module(*self.dev_feeds, *self.params)
        main.wait_stream(self.stream)
        specs = [(tuple(o.shape), o.dtype) for o in outs]
        del outs
        self.dev_out, dev_outs = _packed(specs, self.device, pin=False)
        self.host_out, self.host_fetches = _packed(specs, "cpu", pin=True)

        def run():
            for buf, o in zip(dev_outs,
                              self.module(*self.dev_feeds, *self.params)):
                buf.copy_(o)

        self.graph, self.per_replay = capture_graph(
            run, self.device, self.stream, caller="NativePredictor")

    def __call__(self, arrays: List[np.ndarray]) -> List[np.ndarray]:
        from .executor import _to_numpy
        from .ops import _cuda
        from .profiler import RecordEvent

        for buf, a in zip(self.host_feeds, arrays):
            buf.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        self.dev_in.copy_(self.host_in, non_blocking=True)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        _cuda.add_launches(self.per_replay, 1)
        self.host_out.copy_(self.dev_out, non_blocking=True)
        with RecordEvent("fetch_sync"):
            torch.cuda.current_stream(self.device).synchronize()
        return [_to_numpy(t) for t in self.host_fetches]


class NativePredictor:
    """Exported-program predictor (reference: api/api_impl.cc
    NativePaddlePredictor): the batch-1 program loaded at construction,
    the parameters on the device once, ``run()`` on feed arrays."""

    def __init__(self, config: NativeConfig):
        from .io import _npz_tensors, _seed_tuned_configs

        self.config = config
        d = config.model_dir
        with open(os.path.join(
                d, config.model_filename or "__model__.json")) as f:
            self.manifest = json.load(f)
        # the exporter's tuned kernel configs, before any launch
        _seed_tuned_configs(self.manifest)
        enforce("torch_export" in self.manifest,
                "model dir %s has no 'torch_export' artifact%s — re-export "
                "with paddle_tpu_torch's save_inference_model("
                "export_stablehlo=True)" % (
                    d, " (it holds the JAX package's 'stablehlo' module, "
                    "which the port cannot run)"
                    if "stablehlo" in self.manifest else ""))
        if config.use_gpu:
            enforce(torch.cuda.is_available(),
                    "NativePredictor: use_gpu is on but no CUDA device is "
                    "visible (pass use_gpu=False to run on the CPU)")
            self.device = torch.device("cuda", config.device)
        else:
            self.device = torch.device("cpu")
        self.feed_names: List[str] = self.manifest["feed_names"]
        self.fetch_names: List[str] = self.manifest["fetch_names"]
        self.param_names: List[str] = self.manifest["param_names"]
        # the feeds the exported graph takes (a feed no op reads is none)
        self._graph_feeds = [self.feed_names.index(n) for n in
                             self.manifest.get("torch_export_feeds",
                                               self.feed_names)]
        self._batch = int(self.manifest.get("torch_export_batch_size", 1))
        # batch size -> exported program file; every artifact has at
        # least the default-batch program
        self._files: Dict[int, str] = {
            int(k): v for k, v in
            self.manifest.get("torch_export_buckets", {}).items()}
        self._files.setdefault(self._batch, self.manifest["torch_export"])
        self._modules: Dict[int, object] = {}
        self._graphs: Dict[int, _BucketGraph] = {}
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._module(self._batch)  # prepare once
        params_path = os.path.join(d, config.params_filename or "__params__")
        if not params_path.endswith(".npz"):
            params_path += ".npz"
        loaded = _npz_tensors(params_path, self.manifest, self.device)
        self._params = [loaded[n] for n in self.param_names]
        # per-feed (shape, dtype) the programs were exported with
        self._feed_meta = {
            n: self.manifest["vars"][n] for n in self.feed_names}

    # ------------------------------------------------------------------
    @property
    def compile_count(self) -> int:
        """CUDA graphs captured so far, one per bucket run (0 on the
        CPU, where nothing is captured)."""
        return sum(g.graph is not None for g in self._graphs.values())

    @property
    def cache_hits(self) -> int:
        """Always 0: the predictor loads programs that are already
        exported and compiles nothing, so the compile cache has nothing
        to serve it (the JAX package counts its PJRT compiles' hits)."""
        return 0

    def available_batch_sizes(self) -> List[int]:
        """Batch sizes with an exported program in the artifact."""
        return sorted(self._files)

    def _module(self, batch: int):
        """The loaded program for one batch bucket, loaded once."""
        from .io import load_exported

        module = self._modules.get(batch)
        if module is None:
            enforce(batch in self._files,
                    "no exported program for batch size %s in %s "
                    "(exported buckets: %s) — re-export with "
                    "save_inference_model(export_batch_sizes=...)"
                    % (batch, self.config.model_dir, sorted(self._files)))
            module = self._modules[batch] = load_exported(
                os.path.join(self.config.model_dir, self._files[batch]),
                self.device)
        return module

    def _one(self, arrays: List[np.ndarray], batch: int) -> List[np.ndarray]:
        module = self._module(batch)
        names = [self.feed_names[i] for i in self._graph_feeds]
        arrays = [arrays[i] for i in self._graph_feeds]
        if self.device.type != "cuda":
            from .executor import _to_numpy

            feeds = [torch.from_numpy(np.ascontiguousarray(a)).to(
                dtype_utils.to_torch(self._feed_meta[n]["dtype"]))
                for n, a in zip(names, arrays)]
            with torch.no_grad():
                return [_to_numpy(o) for o in module(*feeds, *self._params)]
        graph = self._graphs.get(batch)
        if graph is None:
            specs = [(tuple(np.shape(a)), dtype_utils.to_torch(
                self._feed_meta[n]["dtype"]))
                for n, a in zip(names, arrays)]
            graph = self._graphs[batch] = _BucketGraph(
                module, specs, self._params, self.device, self._stream)
        return graph(arrays)

    def run_batch(self, feed: Dict[str, np.ndarray]) -> List[np.ndarray]:
        """Batch-capable run: an arbitrary feed batch decomposed greedily
        over the artifact's buckets (largest first), the fetches
        concatenated. A batch that IS a bucket size runs as one call —
        the serving engine's hot path (it pads up to a bucket first)."""
        arrays, batch = self._normalize_feed(feed)
        if batch in self._files:
            return self._one(arrays, batch)
        sizes = sorted(self._files, reverse=True)

        def cut(a, start, b):
            # only batch-major arrays are sliced
            if getattr(a, "ndim", 0) and a.shape[0] == batch:
                return a[start:start + b]
            return a

        chunks, start = [], 0
        while start < batch:
            left = batch - start
            if left in self._files:
                b = left
            elif left >= sizes[0]:
                b = sizes[0]
            else:
                b = next((s for s in sizes if s <= left), None)
                enforce(b is not None,
                        "cannot decompose batch %s over exported buckets "
                        "%s (remainder %s is smaller than every bucket) — "
                        "re-export with a batch-1 program"
                        % (batch, sorted(self._files), left))
            chunks.append(self._one([cut(a, start, b) for a in arrays], b))
            start += b
        if len(chunks) == 1:
            return chunks[0]
        return [np.concatenate([c[i] for c in chunks], axis=0)
                for i in range(len(chunks[0]))]

    def _normalize_feed(self, feed: Dict[str, np.ndarray]):
        missing = [n for n in self.feed_names if n not in feed]
        enforce(not missing, "missing feeds: %s" % missing)
        arrays, batch = [], None
        for n in self.feed_names:
            a = np.asarray(feed[n])
            dt = self._feed_meta[n]["dtype"]
            # numpy has no bfloat16: such a feed stays f32 here and is
            # cast where it meets the program
            arrays.append(a if dt == "bfloat16" else a.astype(dt))
            if batch is None:
                batch = a.shape[0] if a.ndim else 1
        return arrays, batch

    def run(self, inputs: Union[Sequence[PaddleTensor], Dict[str, np.ndarray]]
            ) -> List[PaddleTensor]:
        """reference: PaddlePredictor::Run (paddle_inference_api.h:95).

        A feed dict or a list of PaddleTensors (matched by name, or by
        feed order when unnamed); batches that are no bucket run in
        slices and are re-stacked."""
        if isinstance(inputs, dict):
            feed = {k: np.asarray(v) for k, v in inputs.items()}
        else:
            feed = {}
            for i, t in enumerate(inputs):
                name = t.name or self.feed_names[i]
                feed[name] = np.asarray(t.data)
        outs = self.run_batch(feed)
        return [PaddleTensor(o, name=n)
                for o, n in zip(outs, self.fetch_names)]

    def clone(self) -> "NativePredictor":
        return NativePredictor(self.config)


def create_paddle_predictor(config: NativeConfig) -> NativePredictor:
    """reference: CreatePaddlePredictor (paddle_inference_api.h:148)."""
    return NativePredictor(config)
