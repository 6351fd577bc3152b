"""The inference pipeline (port of box2mask_tpu/engine/infer.py:46-156).

Per batch: the numpy batch is packed into one compact-wire buffer
(engine/hostload.py, the JAX package's codecs and per-signature fallback
chain) in a pinned host buffer, on a packer thread one batch ahead of the
main thread, and shipped in ONE non-blocking copy; the batch is decoded on
the card, one forward + per-scene device post-processing runs, and a
harvest thread copies the small stacked result back and unpacks the masks
on the host, at software-pipeline depth DEPTH = 2: batch i's harvest
overlaps the next batches' device work.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from box2mask_torch import tracing
from box2mask_torch.engine import state as S
from box2mask_torch.engine.hostload import BatchUploader
from box2mask_torch.postprocess.device_post import (
    MAX_MASKS, fused_postproc, make_core, make_device_postproc,
    stacked_masks_to_results)
from box2mask_torch.runtime import resolve_device

DEPTH = 2


class FusedInferencePipeline:
    """Streaming fused inference over an iterator of (dev_np, host) batches.
    `run` yields per-batch `(results, out_np, dev_np, host)` IN ORDER, where
    `results` is the detection_to_masks-compatible dict {scene_name: {conf,
    label_id, mask}} (point-level masks in eval mode). `pack_s` and
    `wire_bytes` count the host packing seconds and the bytes shipped of
    the last `run` (its scenes: tracing.counts());
    `uploader.wires()` says which wire each batch signature took."""

    def __init__(self, cfg, valid_class_ids, is_foreground, model=None,
                 top_k=128, max_masks=MAX_MASKS, device=None):
        self.device = resolve_device(device)
        self.uploader = BatchUploader(self.device)
        self.cfg = cfg
        self.valid_class_ids = valid_class_ids
        self.model = model or S.build_model(cfg, len(valid_class_ids),
                                            self.device)
        self.top_k = top_k
        self.core = make_core(cfg, valid_class_ids, is_foreground, max_masks)
        self.post_full = make_device_postproc(cfg, valid_class_ids,
                                              is_foreground, max_masks)
        self._harvester = ThreadPoolExecutor(max_workers=3)
        self._packer = ThreadPoolExecutor(max_workers=1)

    @property
    def pack_s(self):
        return self.uploader.pack_s

    @property
    def wire_bytes(self):
        return self.uploader.wire_bytes

    @torch.no_grad()
    def infer(self, batch, ths):
        """One batch of device tensors -> (pred, full batch, stacked out)."""
        with tracing.span('b2m.infer.forward'):
            full = S.ensure_maps(batch)
            pred = self.model(full)
        with tracing.span('b2m.infer.post'):
            out = fused_postproc(self.core, self.cfg, pred, full, ths,
                                 self.top_k)
        return pred, full, out

    def _harvest(self, pred, full, out, host, ths):
        with tracing.span('b2m.infer.harvest'):
            with tracing.span('b2m.harvest.readback'):
                out_np = {k: v.cpu().numpy() for k, v in out.items()}
            with tracing.span('b2m.harvest.unpack'):
                results = stacked_masks_to_results(
                    out_np, host, self.valid_class_ids,
                    post_fallback=self.post_full, pred=pred, dev_t=full,
                    ths=ths, native=self.cfg.use_native_host_ops)
        return results, out_np

    def _ahead(self, batches):
        """(packing future, dev_np, host) per batch: batch i + 1 is handed
        to the packer thread before batch i is yielded, so its packing
        overlaps batch i's launches on the main thread."""
        prev = None
        for dev_np, host in batches:
            cur = (self._packer.submit(self.uploader.pack, dev_np), dev_np,
                   host)
            if prev is not None:
                yield prev
            prev = cur
        if prev is not None:
            yield prev

    def run(self, params, batches, ths):
        """Generator: yields (results, out_np, dev_np, host) per batch.
        `params` is a state_dict to load first (None keeps the model's)."""
        if params is not None:
            self.model.load_state_dict(params)
        self.model.eval()
        self.uploader.pack_s, self.uploader.wire_bytes = 0.0, 0
        ths_t = torch.as_tensor(np.asarray(ths, np.float32),
                                device=self.device)
        pending = collections.deque()
        for packed, dev_np, host in self._ahead(batches):
            if 'keys0_b' not in dev_np and len(host['scene']) != 1:
                raise ValueError(
                    'a host-maps batch (coords beyond the key packing range, '
                    'or --host_coordinate_maps) holds one scene: batch size '
                    '1, or a larger --voxel_size')
            tracing.add('scenes', len(host['scene']))
            with tracing.span('b2m.infer.wait_pack'):
                packed = packed.result()
            with tracing.span('b2m.infer.ship'):
                buf, unpack = self.uploader.ship(packed)
                batch = unpack(buf)
            pred, full, out = self.infer(batch, ths_t)
            fut = self._harvester.submit(self._harvest, pred, full, out,
                                         host, ths_t)
            pending.append((fut, dev_np, host))
            while len(pending) > DEPTH:
                yield self._harvested(pending.popleft())
        while pending:
            yield self._harvested(pending.popleft())

    @staticmethod
    def _harvested(item):
        f, dev_np, host = item
        with tracing.span('b2m.infer.wait_harvest'):
            results, out_np = f.result()
        return results, out_np, dev_np, host
