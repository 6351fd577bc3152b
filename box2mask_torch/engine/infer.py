"""The inference pipeline (port of box2mask_tpu/engine/infer.py:46-156).

Per batch: every array of the numpy batch goes to the device through a
pinned host buffer (non-blocking copy), one forward + per-scene device
post-processing runs, and a harvest thread copies the small stacked result
back and unpacks the masks on the host, at software-pipeline depth
DEPTH = 2: batch i's harvest overlaps the next batches' device work.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from box2mask_torch.engine import state as S
from box2mask_torch.postprocess.device_post import (
    fused_postproc, make_core, make_device_postproc, stacked_masks_to_results)
from box2mask_torch.runtime import resolve_device

DEPTH = 2


def upload(dev_np, device):
    """numpy batch dict -> tensors on `device` (pinned staging on CUDA)."""
    out = {}
    for k, v in dev_np.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == 'cuda':
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class FusedInferencePipeline:
    """Streaming fused inference over an iterator of (dev_np, host) batches.
    `run` yields per-batch `(results, out_np, dev_np, host)` IN ORDER, where
    `results` is the detection_to_masks-compatible dict {scene_name: {conf,
    label_id, mask}} (point-level masks in eval mode)."""

    def __init__(self, cfg, valid_class_ids, is_foreground, model=None,
                 top_k=128, max_masks=256, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.valid_class_ids = valid_class_ids
        self.model = model or S.build_model(cfg, len(valid_class_ids),
                                            self.device)
        self.top_k = top_k
        self.core = make_core(cfg, valid_class_ids, is_foreground, max_masks)
        self.post_full = make_device_postproc(cfg, valid_class_ids,
                                              is_foreground, max_masks)
        self._harvester = ThreadPoolExecutor(max_workers=3)
        self.n_scenes = 0

    @torch.no_grad()
    def infer(self, batch, ths):
        """One batch of device tensors -> (pred, full batch, stacked out)."""
        full = S.ensure_maps(batch)
        pred = self.model(full)
        out = fused_postproc(self.core, self.cfg, pred, full, ths, self.top_k)
        return pred, full, out

    def _harvest(self, pred, full, out, host, ths):
        out_np = {k: v.cpu().numpy() for k, v in out.items()}
        results = stacked_masks_to_results(
            out_np, host, self.valid_class_ids,
            post_fallback=self.post_full, pred=pred, dev_t=full, ths=ths,
            native=self.cfg.use_native_host_ops)
        return results, out_np

    def run(self, params, batches, ths):
        """Generator: yields (results, out_np, dev_np, host) per batch.
        `params` is a state_dict to load first (None keeps the model's)."""
        if params is not None:
            self.model.load_state_dict(params)
        self.model.eval()
        self.n_scenes = 0
        ths_t = torch.as_tensor(np.asarray(ths, np.float32),
                                device=self.device)
        pending = collections.deque()
        for dev_np, host in batches:
            if 'keys0_b' not in dev_np and len(host['scene']) != 1:
                raise ValueError(
                    'a host-maps batch (coords beyond the key packing range, '
                    'or --host_coordinate_maps) holds one scene: batch size '
                    '1, or a larger --voxel_size')
            self.n_scenes += len(host['scene'])
            pred, full, out = self.infer(upload(dev_np, self.device), ths_t)
            fut = self._harvester.submit(self._harvest, pred, full, out,
                                         host, ths_t)
            pending.append((fut, dev_np, host))
            while len(pending) > DEPTH:
                f, d, h = pending.popleft()
                yield (*f.result(), d, h)
        while pending:
            f, d, h = pending.popleft()
            yield (*f.result(), d, h)
