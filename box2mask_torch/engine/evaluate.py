"""The evaluation engine: the port of the fused part of
box2mask_tpu/engine/evaluate.py.

Checkpoint selection (explicit / closest-to-N-hours / latest, :59), the
fused inference pipeline over a dataset with a pickle cache of its compact
stacked readbacks (:149-211), the official ScanNet AP protocol with its
result folder, table and PR curves (:434-492), and the ScanNet-benchmark
submission write-out (:685). The model runs on the card unless the caller
asks for the CPU (`device='cpu'`).

The port has only the fused path, for ScanNet and synthetic scenes. Not
ported yet, and refused with NotImplementedError naming the ROADMAP item:
ARKitScenes and S3DIS evaluation, the param search and the non-fused path
with the host oracle detection2mask (A10), and spatially sharded
evaluation (A13).
"""

from __future__ import annotations

import hashlib
import os
import pickle
import uuid

import numpy as np

from box2mask_torch.datasets.tables import get_tables
from box2mask_torch.engine import checkpoint as ckpt
from box2mask_torch.engine import state as S
from box2mask_torch.engine.infer import FusedInferencePipeline
from box2mask_torch.metrics import scannet_ap
from box2mask_torch.postprocess.device_post import stacked_masks_to_results
from box2mask_torch.runtime import resolve_device

TOP_K = 128                     # rows per scene in the stacked readback


def _not_ported(what, item):
    return NotImplementedError(f'{what} is not ported to box2mask_torch yet '
                               f'(ROADMAP {item})')


class Evaluater:
    """`state` (an engine/state.TrainState, e.g. the Trainer's live one) is
    evaluated as it is; without one the model is built and restored from
    the experiment's checkpoint at first use."""

    def __init__(self, cfg, state=None, writer=None, epoch=None,
                 device=None):
        self.cfg = cfg
        self.writer = writer
        self.epoch = epoch
        (self.valid_class_ids, self.sem_id2idx, self.inst_id2idx,
         self.is_foreground) = get_tables(
            cfg.dataset_name if cfg.dataset_name != 'synthetic' else 'scannet')
        self.device = (next(state.model.parameters()).device
                       if state is not None else resolve_device(device))
        self.state = state
        self.ckpt_name = 'untrained'
        self._needs_restore = state is None
        self.results_path = None

    # ------------------------------------------------------------ state mgmt
    def _ensure_state(self):
        """Build the model and restore the checkpoint once (the JAX
        package's _ensure_state and _ensure_state_from_dataset: the port
        needs no sample batch to build it), and make the results folder."""
        cfg = self.cfg
        if self.state is None:
            model = S.build_model(cfg, len(self.valid_class_ids), self.device)
            self.state = S.init_state(cfg, model, S.make_optimizer(cfg),
                                      seed=cfg.fixed_seed or 0)
        if self._needs_restore:
            path = ckpt.find_checkpoint(cfg.checkpoint_path, cfg.checkpoint,
                                        cfg.load_ckpt_closest_to)
            if path is not None and os.path.exists(path):
                (self.state, _, _, _, self.ckpt_name) = ckpt.load_checkpoint(
                    path, self.state, strict=not cfg.loose_model_loading)
                print(f'Loaded checkpoint: {self.ckpt_name}')
            else:
                print(f'No checkpoint at {cfg.checkpoint_path}; '
                      'evaluating the untrained model')
            self._needs_restore = False
        if self.results_path is None:
            self.results_path = os.path.join(cfg.exp_path, 'results',
                                             self.ckpt_name)
            os.makedirs(self.results_path, exist_ok=True)

    # ------------------------------------------------------------ prediction
    def _predictions_cache_path(self, batch_size, dataset=None):
        seed = self.cfg.fixed_seed if self.cfg.fixed_seed else 'noseed'
        tag = ''
        if dataset is not None:
            names = ','.join(str(n) for n in dataset.data_list[:8])
            h = hashlib.sha1(f'{dataset.mode}:{len(dataset)}:{names}'
                             .encode()).hexdigest()[:8]
            tag = f'_{dataset.mode}_{h}'
        return os.path.join(self.results_path,
                            f'predictions_bs{batch_size}_seed{seed}{tag}.pkl')

    def dataset_prediction(self, dataset, batch_size=1, cache=True):
        raise _not_ported('the non-fused prediction path (raw head outputs '
                          'for the host oracle detection2mask)', 'A10')

    def pred_entries_to_results(self, entries, ths=None):
        raise _not_ported('the host oracle detection2mask', 'A10')

    def param_search(self, dataset):
        raise _not_ported('the eval-threshold param search', 'A10')

    def _require_fused(self):
        """The fused pipeline is the port's only path (the JAX package's
        _use_fused, :136): ScanNet and synthetic scenes, unsharded."""
        if self.cfg.spatial_shards > 1:
            raise _not_ported('spatially sharded evaluation', 'A13')
        if self.cfg.dataset_name not in ('scannet', 'synthetic'):
            raise _not_ported(f'{self.cfg.dataset_name} evaluation', 'A10')

    def fused_dataset_results(self, dataset, ths=None, cache=True):
        """Product inference: returns (results, light_entries).

        `results` is {scene: {conf, label_id, mask}} with point-level masks
        straight from the stacked readbacks; `light_entries` [(None, None,
        host), ...] carry the per-scene host data the protocol needs (GT).
        Cached per (batch size, seed, split, thresholds) as the stacked
        readbacks, the hosts and the fallback results of top-k overflow
        scenes (a reload cannot re-run the device fallback)."""
        self._ensure_state()
        cfg = self.cfg
        ths = tuple(float(t) for t in
                    (ths if ths is not None else cfg.eval_ths))
        bs = max(1, int(cfg.eval_batch_size or 1))
        path = self._predictions_cache_path(bs, dataset)[:-4] \
            + '_fused_' + '_'.join(str(t) for t in ths) + '.pkl'
        if cache and os.path.exists(path):
            print(f'Reusing cached fused readbacks: {path}')
            with open(path, 'rb') as f:
                cached = pickle.load(f)
            results, entries = {}, []
            for out_np, host, overflow_results in cached:
                results.update(stacked_masks_to_results(
                    out_np, host, self.valid_class_ids,
                    native=cfg.use_native_host_ops))
                results.update(overflow_results)
                entries.append((None, None, host))
            return results, entries

        if not hasattr(self, '_fused_pipe'):
            self._fused_pipe = FusedInferencePipeline(
                cfg, self.valid_class_ids, self.is_foreground,
                model=self.state.model, top_k=TOP_K, device=self.device)
        loader = dataset.get_loader(shuffle=False, drop_last=False,
                                    batch_size=bs)
        results, entries, to_cache = {}, [], []
        for batch_results, out_np, _, host in self._fused_pipe.run(
                None, loader, ths):
            results.update(batch_results)
            entries.append((None, None, host))
            print(f'predicted {[s["name"] for s in host["scene"]]}')
            if cache:
                overflow = {s['name']: batch_results[s['name']]
                            for si, s in enumerate(host['scene'])
                            if out_np['topk_overflow'][si]}
                to_cache.append((out_np, host, overflow))
        if cache:
            with open(path, 'wb') as f:
                pickle.dump(to_cache, f)
        return results, entries

    # ------------------------------------------------------------------ eval
    def eval(self, dataset, write_to_tb=None):
        self._require_fused()
        results, entries = self.fused_dataset_results(dataset)
        return self.scannet_eval(results, entries, write_to_tb=write_to_tb)

    # ---------------------------------------------------------- ScanNet eval
    def gt_ids_for_entries(self, entries):
        """GT per-point ids: from gt_instance_data_txt when present (the
        reference's gt encoding, utils/gt2eval.py:15), else derived from
        labels."""
        gt_root = os.path.join(self.cfg.data_dir, 'gt_instance_data_txt')
        out = {}
        for _, _, host in entries:
            for scene, labels in zip(host['scene'], host['labels']):
                name = scene['name']
                txt = os.path.join(gt_root, f'{name}.txt')
                if os.path.exists(txt):
                    out[name] = np.loadtxt(txt, dtype=np.int64)
                else:
                    out[name] = scannet_ap.encode_gt_ids(
                        labels['semantics'], labels['instances'])
        return out

    def scannet_eval(self, results, entries, write_to_tb=None):
        gt_ids = self.gt_ids_for_entries(entries)
        avgs, ap, pr_curves = scannet_ap.evaluate_scannet(results, gt_ids)
        table = scannet_ap.format_results_table(avgs)
        print(table)

        folder = os.path.join(
            self.results_path,
            ('param_search/' if self.cfg.eval_specific_param else '')
            + f"mAP50_{avgs['all_ap_50%']:.3f}_eval_ths:"
            + '_'.join(str(t) for t in (self.cfg.eval_ths or []))
            + (f'_seed:{self.cfg.fixed_seed}' if self.cfg.fixed_seed
               else f'_rid:{str(uuid.uuid1())[:8]}'))
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, 'table.txt'), 'w') as f:
            f.write(table + '\n')
        self._write_pr_curves(folder, pr_curves)
        if self.writer is not None and self.epoch is not None:
            self.writer.add_scalar('val/mAP', avgs['all_ap'], self.epoch)
            self.writer.add_scalar('val/mAP50', avgs['all_ap_50%'], self.epoch)
            self.writer.add_scalar('val/mAP25', avgs['all_ap_25%'], self.epoch)
        return avgs

    def _write_pr_curves(self, folder, pr_curves):
        try:
            import matplotlib
            matplotlib.use('Agg')
            import matplotlib.pyplot as plt
            for th in (0.25, 0.5):
                if th not in pr_curves:
                    continue
                fig, ax = plt.subplots(figsize=(7, 6))
                for label, (prec, rec) in pr_curves[th].items():
                    ax.plot(rec, prec, label=label)
                ax.set_xlabel('recall')
                ax.set_ylabel('precision')
                ax.set_title(f'PR curves @ IoU {th}')
                ax.legend(fontsize=6)
                fig.savefig(os.path.join(folder, f'pr_curves_{th}.png'),
                            dpi=120)
                plt.close(fig)
        except Exception as e:
            print(f'PR curve plotting failed: {e}')

    # ------------------------------------------------------------ submission
    def submission_write_out(self, dataset, out_dir=None):
        """ScanNet benchmark format: <scene>.txt lines
        'predicted_masks/<scene>_<j>.txt label conf' + 0/1 mask files
        (reference evaluation.py:617-650)."""
        self._require_fused()
        results, _ = self.fused_dataset_results(dataset)
        out_dir = out_dir or os.path.join(self.results_path, 'submission')
        mask_dir = os.path.join(out_dir, 'predicted_masks')
        os.makedirs(mask_dir, exist_ok=True)
        for name, r in results.items():
            lines = []
            for j in range(len(r['conf'])):
                mask_file = f'predicted_masks/{name}_{j:03d}.txt'
                lines.append(f'{mask_file} {int(r["label_id"][j])} '
                             f'{float(r["conf"][j]):.4f}')
                np.savetxt(os.path.join(out_dir, mask_file),
                           np.asarray(r['mask'][j]).astype(np.int32), fmt='%d')
            with open(os.path.join(out_dir, f'{name}.txt'), 'w') as f:
                f.write('\n'.join(lines) + '\n')
        print(f'Submission written to {out_dir}')
        return out_dir
