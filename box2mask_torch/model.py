"""Model facade of the port: the `Model` of box2mask_tpu/model.py:21-115
(itself the reference's Model wrapper surface) over the port's engine, with
the same names and call shapes.

It holds the SelectionNet and its TrainState and offers ensure_state,
compute_loss, train_step, get_prediction (with the min_bb_size clip of the
bounds), pred2mask (the host post-processing, postprocess/detection2mask.py),
state_dict, load_checkpoint (the port's checkpoints and the JAX package's),
eval and train. Batches are the loader's numpy dicts (or tensors); they are
moved to the model's device. It runs on the card unless `device='cpu'` is
given; without CUDA and without that request it raises. New code may call
the engine (engine/state.py) directly.
"""

from __future__ import annotations

import numpy as np
import torch

from box2mask_torch.engine import checkpoint as ckpt
from box2mask_torch.engine import state as S
from box2mask_torch.postprocess.detection2mask import detection_to_masks
from box2mask_torch.runtime import resolve_device

_NUMERIC = (np.ndarray, np.generic, int, float, bool)


class Model:
    def __init__(self, cfg, semantic_valid_class_ids, semantic_id2idx,
                 instance_id2idx, is_foreground, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.semantic_valid_class_ids = np.asarray(semantic_valid_class_ids)
        self.semantic_id2idx = np.asarray(semantic_id2idx)
        self.instance_id2idx = np.asarray(instance_id2idx)
        self.is_foreground = is_foreground
        self.detection_model = S.build_model(
            cfg, len(self.semantic_valid_class_ids), self.device)
        self.tx = S.make_optimizer(cfg)
        self.state = None
        self._train_step = S.make_train_step(cfg)
        self._val_step = S.make_val_step(cfg)

    # ------------------------------------------------------------------ state
    def ensure_state(self, batch=None, seed=0):
        """The train state, made at the first call (seeded kaiming weights,
        a fresh optimizer state). `batch` is accepted for the JAX facade's
        call shape; torch modules need no sample to size their weights."""
        if self.state is None:
            self.state = S.init_state(self.cfg, self.detection_model, self.tx,
                                      seed=seed)
        return self.state

    def _device_batch(self, batch):
        out = {}
        for k, v in batch.items():
            if torch.is_tensor(v):
                out[k] = v.to(self.device)
            elif isinstance(v, _NUMERIC):
                out[k] = torch.as_tensor(np.asarray(v)).to(self.device)
        return out

    # ------------------------------------------------------------------ train
    def compute_loss(self, batch, epoch):
        """One loss evaluation in eval mode, no optimizer step (the
        reference's Model.compute_loss): the loss dict as numpy."""
        dev = self._device_batch(batch)
        self.ensure_state(dev)
        bb_w, cs_w = S.head_weights(self.cfg, epoch)
        ld = self._val_step(self.state, dev, bb_w, cs_w)
        return {k: v.cpu().numpy() for k, v in ld.items()}

    def train_step(self, batch, epoch, lr=None):
        """One train step at `lr` (cfg.lr by default): the loss dict as
        numpy."""
        dev = self._device_batch(batch)
        self.ensure_state(dev)
        bb_w, cs_w = S.head_weights(self.cfg, epoch)
        self.state, ld = self._train_step(
            self.state, dev, lr if lr is not None else self.cfg.lr, bb_w,
            cs_w)
        return {k: v.cpu().numpy() for k, v in ld.items()}

    # ------------------------------------------------------------- prediction
    def get_prediction(self, batch, with_grad=False, to_cpu=True,
                       min_size=True, get_all=False):
        """The raw head outputs of the eval forward (engine/state.forward),
        as numpy (on the device with to_cpu=False), the bounds clipped below
        at cfg.min_bb_size unless min_size is False. with_grad and get_all
        are accepted for the reference's call shape, as in the JAX
        facade."""
        dev = self._device_batch(batch)
        self.ensure_state(dev)
        pred = S.forward(self.detection_model, dev)
        if (min_size and self.cfg.min_bb_size is not None
                and self.cfg.mlp_bounds in pred):
            pred[self.cfg.mlp_bounds] = torch.clamp(
                pred[self.cfg.mlp_bounds], min=self.cfg.min_bb_size)
        if to_cpu:
            pred = {k: v.cpu().numpy() for k, v in pred.items()}
        return pred

    def pred2mask(self, batch, pred, mode, host=None):
        """Per-scene masks, labels and confidences from the raw heads, by
        the host post-processing at cfg.eval_ths."""
        dev = {k: (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
               for k, v in batch.items() if not isinstance(v, list)}
        pred = {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                for k, v in pred.items()}
        host = host or batch.get('__host__')
        return detection_to_masks(pred, dev, host, self.cfg,
                                  self.semantic_valid_class_ids,
                                  self.is_foreground, mode, True,
                                  self.cfg.eval_ths)

    # ------------------------------------------------------------ checkpoints
    def state_dict(self):
        """{'params': ..., 'batch_stats': ...}, numpy arrays by state_dict
        name."""
        params, stats = ckpt.split_state(self.detection_model)
        return {'params': params, 'batch_stats': stats}

    def load_checkpoint(self, checkpoint=None, closest_to=None):
        """Restore the named, the closest-to-N-hours or the latest
        checkpoint of the experiment; returns (epoch, training_time, name,
        iteration_num), or (0, 0) when there is none."""
        path = ckpt.find_checkpoint(self.cfg.checkpoint_path, checkpoint,
                                    closest_to)
        if path is None:
            print(f'No checkpoints found at {self.cfg.checkpoint_path}')
            return 0, 0
        if self.state is None:
            raise RuntimeError('call ensure_state(batch) first')
        (self.state, epoch, training_time, iteration_num,
         name) = ckpt.load_checkpoint(
            path, self.state, strict=not self.cfg.loose_model_loading)
        print(f'Loaded checkpoint from: {path}')
        return epoch, training_time, name, iteration_num

    def eval(self):
        self.detection_model.eval()

    def train(self):
        self.detection_model.train()
