"""The evaluation engine: the port of box2mask_tpu/engine/evaluate.py.

Checkpoint selection (explicit / closest-to-N-hours / latest, :59); the
fused inference pipeline over a dataset with a pickle cache of its compact
stacked readbacks (:149-219); the non-fused path (:95-133, :336-394): raw
head outputs of the forward on the card read back and cached, then masks
from the device post-processing on the card or from the host oracle
postprocess/detection2mask.py; the per-dataset protocols, ScanNet official
AP (:434-492), ARKitScenes VOC AP on oriented boxes (:495) and S3DIS
mPrecision / mRecall (:548-651); the eval-threshold param search (:654);
and the ScanNet-benchmark submission write-out (:685). The model runs on the
card unless the caller asks for the CPU (`device='cpu'`).

Routes. ScanNet, synthetic and ARKitScenes scenes take the fused pipeline,
as in the JAX package. S3DIS takes it only when both the semantics head and
the per-voxel semantics head are configured: the fused post-processing
reads the semantics head, which the shipped S3DIS presets do not have (the
JAX package sends them down the fused path all the same, and raises
KeyError there); they take the non-fused route with the host oracle, the
route the JAX package takes off the TPU.

Spatially sharded (--spatial_shards D, :222-307, :398-410): ScanNet,
synthetic and ARKitScenes scenes are evaluated one at a time, each split
over the D ranks of a process group (parallel/spatial.py; the evaluate CLI
spawns them), every rank running its slab of the forward; rank 0 runs the
post-processing on the replicated segment-level heads and the protocol.
S3DIS stays off this path, as in the JAX package, and so do the submission
write-out and the param search, which run on one device there too.
"""

from __future__ import annotations

import copy
import hashlib
import os
import pickle
import uuid

import numpy as np
import torch
import torch.distributed as dist
from scipy.spatial import ConvexHull, cKDTree

from box2mask_torch.datasets import s3dis as s3dis_reader
from box2mask_torch.datasets.tables import (ARKITSCENES_ID2NAME,
                                            S3DIS_CLASS_LABELS, get_tables)
from box2mask_torch.engine import checkpoint as ckpt
from box2mask_torch.engine import state as S
from box2mask_torch.engine.hostload import upload
from box2mask_torch.engine.infer import FusedInferencePipeline
from box2mask_torch.metrics import box3d, detection_ap, s3dis_metrics
from box2mask_torch.metrics import scannet_ap
from box2mask_torch.parallel import spatial as SP
from box2mask_torch.postprocess.detection2mask import detection_to_masks
from box2mask_torch.postprocess.device_post import (
    MAX_MASKS, device_masks_to_results, make_core, make_device_postproc,
    stacked_masks_to_results, warn_cap)
from box2mask_torch.postprocess.s3dis_background import (
    assign_semantics_to_proposals, clustering_for_background)
from box2mask_torch.runtime import resolve_device

TOP_K = 128                     # rows per scene in the stacked readback
# the batch arrays a raw-prediction entry keeps for the post-processing
KEEP = ('num_segments', 'input_location', 'batch_ids', 'batch0', 'num0',
        'seg_valid', 'valid0', 'pooling_ids')
# the datasets whose evaluation --spatial_shards splits over ranks
SPATIAL_DATASETS = ('scannet', 'synthetic', 'arkitscenes')


class Evaluater:
    """`state` (an engine/state.TrainState, e.g. the Trainer's live one) is
    evaluated as it is; without one the model is built and restored from
    the experiment's checkpoint at first use."""

    def __init__(self, cfg, state=None, writer=None, epoch=None,
                 device=None, rank=0, world_size=1, group=None):
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
        self.rank, self.world_size = rank, world_size
        self.group = group if world_size > 1 else None
        self.spatial = (cfg.spatial_shards > 1
                        and cfg.dataset_name in SPATIAL_DATASETS)

    # ------------------------------------------------------------ state mgmt
    def _ensure_state(self, spatial=False):
        """Build the model and restore the checkpoint once (the JAX
        package's _ensure_state, _ensure_state_from_dataset and, with
        `spatial`, _ensure_state_spatial: the port needs no sample batch to
        build it), and make the results folder. Every entry point that runs
        the model passes here; under --spatial_shards the submission
        write-out and the param search run the one-device net, as the JAX
        package's do."""
        cfg = self.cfg
        if spatial and (self.group is None or dist.get_world_size(
                self.group) != cfg.spatial_shards):
            raise RuntimeError(
                f'--spatial_shards {cfg.spatial_shards} evaluates on a '
                f'process group of {cfg.spatial_shards} ranks (python -m '
                'box2mask_torch.evaluate spawns them)')
        if self.state is None and spatial:
            self.state = SP.make_spatial_init(
                cfg, SP.build_spatial_model(cfg, len(self.valid_class_ids),
                                            self.device, self.group),
                self.group, seed=cfg.fixed_seed or 0)
        elif self.state is None:
            model = S.build_model(cfg, len(self.valid_class_ids),
                                  self.device)
            self.state = S.init_state(cfg, model, S.make_optimizer(cfg),
                                      seed=cfg.fixed_seed or 0)
        if self._needs_restore:
            path = ckpt.find_checkpoint(cfg.checkpoint_path, cfg.checkpoint,
                                        cfg.load_ckpt_closest_to)
            if path is not None and os.path.exists(path):
                (self.state, _, _, _, self.ckpt_name) = ckpt.load_checkpoint(
                    path, self.state, strict=not cfg.loose_model_loading)
                msg = f'Loaded checkpoint: {self.ckpt_name}'
            else:
                msg = (f'No checkpoint at {cfg.checkpoint_path}; '
                       'evaluating the untrained model')
            if self.rank == 0:
                print(msg)
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
        """The forward on the card over the dataset; returns [(pred, dev,
        host), ...] with the raw head outputs and the KEEP batch arrays as
        numpy, cached (pickle) per batch size, seed and split. Batch b is
        read back while b + 1 and b + 2 run (depth 2, as in the JAX
        package)."""
        self._ensure_state()
        loader = dataset.get_loader(shuffle=False, drop_last=False,
                                    batch_size=batch_size)
        entries, pending = [], []

        def harvest(pred, keep, host):
            entries.append(({k: v.cpu().numpy() for k, v in pred.items()},
                            keep, host))
            print(f'predicted {[s["name"] for s in host["scene"]]}')

        for dev_np, host in loader:
            pred = S.forward(self.state.model, upload(dev_np, self.device))
            keep = {k: dev_np[k] for k in KEEP if k in dev_np}
            pending.append((pred, keep, host))
            if len(pending) > 2:
                harvest(*pending.pop(0))
        for p in pending:
            harvest(*p)
        if cache:
            with open(self._predictions_cache_path(batch_size, dataset),
                      'wb') as f:
                pickle.dump(entries, f)
        return entries

    def load_or_predict(self, dataset, batch_size=1):
        self._ensure_state()
        path = self._predictions_cache_path(batch_size, dataset)
        if os.path.exists(path):
            print(f'Reusing cached predictions: {path}')
            with open(path, 'rb') as f:
                return pickle.load(f)
        return self.dataset_prediction(dataset, batch_size)

    def _post_on_device(self):
        """The device post-processing serves raw predictions on the card
        when the config has the semantics head it reads (the JAX package's
        rule on the TPU, :365-369, with the head check its fused S3DIS path
        lacks)."""
        return (self.device.type == 'cuda'
                and self.cfg.mlp_semantics in self.cfg.network_heads)

    def device_entries_to_results(self, entries, ths=None):
        """Raw predictions -> results through make_device_postproc, scene
        by scene at the whole batch's width, on the Evaluater's device."""
        cfg = self.cfg
        if not hasattr(self, '_device_post'):
            self._device_post = make_device_postproc(
                cfg, self.valid_class_ids, self.is_foreground)
        ths_t = torch.as_tensor(np.asarray(
            ths if ths is not None else cfg.eval_ths, np.float32),
            device=self.device)
        results = {}
        for pred, dev, host in entries:
            pred_t, dev_t = upload(pred, self.device), upload(dev, self.device)
            for si in range(len(host['scene'])):
                out = self._device_post(pred_t, dev_t, si, ths_t)
                results.update(device_masks_to_results(
                    out, host, self.valid_class_ids, si,
                    native=cfg.use_native_host_ops))
        return results

    def pred_entries_to_results(self, entries, ths=None):
        """pred2mask over all batches (models/evaluation.py:94-98): the
        device post-processing on the card (_post_on_device), else the host
        oracle detection_to_masks."""
        if self._post_on_device():
            return self.device_entries_to_results(entries, ths)
        results = {}
        for pred, dev, host in entries:
            results.update(detection_to_masks(
                pred, dev, host, self.cfg, self.valid_class_ids,
                self.is_foreground, mode='eval', ths=ths))
        return results

    def _use_fused(self):
        """ScanNet, synthetic and ARKitScenes scenes ride the fused
        pipeline; S3DIS only with both semantics heads (the module
        docstring says why)."""
        cfg = self.cfg
        if cfg.dataset_name == 's3dis':
            return (cfg.mlp_semantics in cfg.network_heads
                    and cfg.mlp_per_vox_semantics in cfg.network_heads)
        return cfg.dataset_name in ('scannet', 'synthetic', 'arkitscenes')

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
        self._vox_sem = {}      # scene -> u8 per-voxel semantics (S3DIS)
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
                self._collect_vox_sem(out_np, host)
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
            self._collect_vox_sem(out_np, host)
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

    def _collect_vox_sem(self, out_np, host):
        """The per-scene u8 per-voxel semantics plane of a stacked readback
        (present iff the per-voxel head is configured), for
        s3dis_eval_fused."""
        if 'vox_sem' not in out_np:
            return
        for si, s in enumerate(host['scene']):
            self._vox_sem[s['name']] = np.asarray(out_np['vox_sem'][si])

    # ------------------------------------------------- sharded (spatial) eval
    def _spatial_model(self):
        """The state's model as a SpatialSelectionNet over the group (a
        one-device SelectionNet's weights are copied into one: the
        parameters are the same)."""
        model = self.state.model
        if isinstance(model, SP.SpatialSelectionNet):
            return model
        if getattr(self, '_sp_model', None) is None:
            self._sp_model = SP.build_spatial_model(
                self.cfg, len(self.valid_class_ids), self.device, self.group)
        self._sp_model.load_state_dict(model.state_dict())
        return self._sp_model

    def spatial_dataset_results(self, dataset):
        """Sharded evaluation (JAX :222-307): each scene's forward split
        over the group's ranks (parallel/spatial.py), so a scene too large
        for one device evaluates at full resolution. The post-processing
        reads the replicated segment-level heads, so rank 0 runs it
        unsharded over the whole scene's (key-sorted) voxel rows: the
        vote -> mask pipeline is per segment and a mask's IoU does not
        depend on the voxel order. Returns (results, light_entries) as
        fused_dataset_results does, on rank 0; ({}, []) elsewhere."""
        self._ensure_state(spatial=True)
        cfg = self.cfg
        model = self._spatial_model()
        fwd = SP.make_spatial_apply(model)
        if not hasattr(self, '_spatial_core'):
            self._spatial_core = make_core(cfg, self.valid_class_ids,
                                           self.is_foreground, MAX_MASKS)
        ths = torch.as_tensor(np.asarray(cfg.eval_ths, np.float32),
                              device=self.device)
        loader = dataset.get_loader(shuffle=False, drop_last=False,
                                    batch_size=1)
        results, entries = {}, []
        for dev_np, host in loader:
            SP.check_same_scene(dev_np, self.group, self.device)
            pred = fwd(SP.local_batch(dev_np, self.rank, self.device))
            if self.rank != 0:
                continue
            # a one-scene batch over the whole scene's voxel rows, every
            # shard's slab back to back
            valid0 = dev_np['sp_valid0'].reshape(-1)
            flat = upload({
                'pooling_ids': dev_np['sp_pool'].reshape(-1),
                'valid0': valid0,
                'batch0': np.where(valid0, 0, -1).astype(np.int32),
                'input_location': dev_np['input_location'],
                'seg_valid': dev_np['seg_valid'],
                'batch_ids': dev_np['batch_ids']}, self.device)
            with torch.no_grad():
                out = self._spatial_core(pred, flat, 0, ths)
            warn_cap(host, 0, out['cluster_cap_hit'])
            n = int(out['n_keep'])
            segm = out['seg_masks'][:n].cpu().numpy()       # (n, S_pad)
            # segment-level masks -> point masks (the scene's point order):
            # a point's segment is seg2vox[vox2point]
            seg_of_point = np.asarray(host['seg2vox'][0])[
                np.asarray(host['vox2point'][0])]
            name = host['scene'][0]['name']
            label_id = np.asarray(self.valid_class_ids)[
                out['label_idx'][:n].cpu().numpy()]
            results[name] = {
                'conf': out['conf'][:n].cpu().numpy(),
                'label_id': label_id.astype(np.int32),
                'mask': segm[:, seg_of_point] if n else
                np.zeros((0, len(seg_of_point)), bool)}
            entries.append((None, None, host))
            print(f'predicted {name} (spatial x{cfg.spatial_shards})')
        return results, entries

    # ------------------------------------------------------------------ eval
    def eval(self, dataset, write_to_tb=None):
        if self.spatial:
            results, entries = self.spatial_dataset_results(dataset)
            if self.rank != 0:
                return None
            if self.cfg.dataset_name == 'arkitscenes':
                return self.arkitscenes_eval(results, entries)
            return self.scannet_eval(results, entries,
                                     write_to_tb=write_to_tb)
        if not self._use_fused():          # S3DIS without the semantics head
            return self.s3dis_eval(self.load_or_predict(dataset))
        results, entries = self.fused_dataset_results(dataset)
        if self.cfg.dataset_name == 'arkitscenes':
            return self.arkitscenes_eval(results, entries)
        if self.cfg.dataset_name == 's3dis':
            return self.s3dis_eval_fused(results, entries)
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

    # ------------------------------------------------------- ARKitScenes eval
    def arkitscenes_eval(self, results, entries, oriented_boxes=True,
                         iou_t=0.5):
        pred_all, gt_all = {}, {}
        for _, _, host in entries:
            for scene, labels in zip(host['scene'], host['labels']):
                name = scene['name']
                result = results[name]
                gt_list = []
                for i in range(len(labels['per_instance_bb_centers'])):
                    rot = labels['per_instance_bb_rotations'][i].reshape(
                        3, 3).T
                    corners = box3d.oriented_corners(
                        labels['per_instance_bb_bounds'][i], rot,
                        labels['per_instance_bb_centers'][i])
                    gt_list.append([int(labels['per_instance_semantics'][i]),
                                    corners])
                pred_list = []
                for i in range(len(result['label_id'])):
                    mask = np.asarray(result['mask'][i]) > 0
                    pts = scene['positions'][mask]
                    if len(pts) < 50:
                        continue
                    if oriented_boxes:
                        hull = ConvexHull(pts[:, :2])
                        v2 = pts[hull.vertices][:, :2]
                        zmin, zmax = pts[:, 2].min(), pts[:, 2].max()
                        bottom = np.concatenate(
                            [v2, np.full((len(v2), 1), zmin)], axis=1)
                        top = np.concatenate(
                            [v2, np.full((len(v2), 1), zmax)], axis=1)
                        bb = np.concatenate([bottom, top], axis=0)
                    else:
                        mn, mx = pts.min(0), pts.max(0)
                        bb = np.concatenate([(mn + mx) / 2, mx - mn])
                    pred_list.append([int(result['label_id'][i]), bb,
                                      float(result['conf'][i])])
                pred_all[name] = pred_list
                gt_all[name] = gt_list

        iou_func = (lambda a, b: box3d.hull_box_iou(a, b)[0]) \
            if oriented_boxes else box3d.aabb_iou_cs
        rec, prec, ap = detection_ap.eval_det(pred_all, gt_all,
                                              ovthresh=iou_t,
                                              get_iou_func=iou_func)
        for k, v in sorted(ap.items()):
            print(f'{ARKITSCENES_ID2NAME.get(k, k):>15}: \t {v:.3f}')
        vals = [v for v in ap.values() if not np.isnan(v)]
        mAP = float(np.mean(vals)) if vals else 0.0
        print('mAP:', mAP)
        return mAP

    # ------------------------------------------------------------ S3DIS eval
    def s3dis_eval(self, entries):
        """The non-fused route: masks from the host oracle, per-voxel
        semantics from the full head output. The fused path
        (s3dis_eval_fused) gets the argmax from the stacked readback
        instead."""
        per_scene = []
        for pred, dev, host in entries:
            results = detection_to_masks(pred, dev, host, self.cfg,
                                         self.valid_class_ids,
                                         self.is_foreground, mode='eval')
            for si, (scene, labels) in enumerate(zip(host['scene'],
                                                     host['labels'])):
                name = scene['name']
                vox_batch = np.asarray(dev['batch0']) == si
                vox_sem = np.argmax(
                    np.asarray(pred[self.cfg.mlp_per_vox_semantics]), 1)
                vox_sem = vox_sem[vox_batch]
                pred_sem = vox_sem[host['vox2point'][si]]
                per_scene.append((scene, labels, pred_sem,
                                  results[name]['mask'], name))
        return self._s3dis_protocol(per_scene)

    def s3dis_eval_fused(self, results, entries):
        """The fused route: masks from the stacked readback results,
        per-voxel semantics from the u8 `vox_sem` plane
        fused_dataset_results collected (the reference consumes the same
        head, evaluation.py:145-164)."""
        per_scene = []
        for _, _, host in entries:
            for si, (scene, labels) in enumerate(zip(host['scene'],
                                                     host['labels'])):
                name = scene['name']
                vox_sem = self._vox_sem[name].astype(np.int64)
                pred_sem = vox_sem[host['vox2point'][si]]
                per_scene.append((scene, labels, pred_sem,
                                  results[name]['mask'], name))
        return self._s3dis_protocol(per_scene)

    def _s3dis_protocol(self, per_scene):
        gt_labels, pred_labels = [], []
        for scene, labels, pred_sem, masks, name in per_scene:
            bg_inst = clustering_for_background(
                pred_sem, scene['positions'], scene['normals'])
            prop_sem = assign_semantics_to_proposals(pred_sem, masks)

            pred_inst = np.full_like(labels['instances'], -1)
            final_sem = pred_sem.copy()
            for idx, mask in enumerate(masks):
                if prop_sem[idx] < 3:      # bg classes handled separately
                    continue
                mask = np.asarray(mask) > 0
                orig = mask.sum()
                mask = mask & (pred_inst < 0)
                kept = mask.sum()
                if orig == 0 or kept / orig < 0.6 or kept < 200:
                    continue
                pred_inst[mask] = idx + 1
                final_sem[mask] = prop_sem[idx]

            max_id = pred_inst.max()
            bg = bg_inst > 0
            pred_inst[bg] = bg_inst[bg] + max_id
            # suppress per-class small fragments (<200 points)
            for class_id in range(13):
                cm = pred_sem == class_id
                ids, cnts = np.unique(pred_inst[cm], return_counts=True)
                small = np.isin(pred_inst[cm], ids[cnts < 200])
                tmp = pred_inst[cm]
                tmp[small] = -1
                pred_inst[cm] = tmp

            if self.cfg.full_resolution:
                # upsample predictions to the full point cloud by 1-NN
                # against the sampled positions (reference
                # evaluation.py:151-154,216-222 get_sparse2dense)
                full_cfg = copy.copy(self.cfg)
                full_cfg.point_sampling_rate = None
                scene_full, labels_full = s3dis_reader.process_scene(
                    name, 'val', full_cfg, do_augmentations=False)
                tree = cKDTree(scene['positions'])
                _, sparse2dense = tree.query(scene_full['positions'], k=1)
                gt_labels.append({'semantics': labels_full['semantics'],
                                  'instances': labels_full['instances']})
                pred_labels.append(
                    {'semantics': pred_sem[sparse2dense],
                     'instances': pred_inst[sparse2dense]})
                continue
            gt_labels.append({'semantics': labels['semantics'],
                              'instances': labels['instances']})
            pred_labels.append({'semantics': pred_sem,
                                'instances': pred_inst})

        out = s3dis_metrics.evaluate_s3dis(pred_labels, gt_labels)
        print('mean Precision', out['mPrecision'])
        print('mean Recall', out['mRecall'])
        for name, p, r in zip(S3DIS_CLASS_LABELS, out['precision'],
                              out['recall']):
            print(f'{name:>15}: prec {p:.3f} rec {r:.3f}')
        return out

    # ----------------------------------------------------------- param search
    def param_search(self, dataset):
        """Grid over the 4 eval thresholds (reference spawns slurm jobs,
        evaluation.py:353-366; we sweep in-process on cached predictions)."""
        cfg = self.cfg
        entries = self.load_or_predict(dataset)
        grids = [np.linspace(float(a), float(b), int(c)) for a, b, c in
                 (cfg.cluster_th_search, cfg.score_th_search,
                  cfg.mask_bin_th_search, cfg.mask_nms_th_search)]
        best, table = None, []
        for c_th in grids[0]:
            for s_th in grids[1]:
                for b_th in grids[2]:
                    for n_th in grids[3]:
                        ths = (c_th, s_th, b_th, n_th)
                        results = self.pred_entries_to_results(entries,
                                                               ths=ths)
                        gt_ids = self.gt_ids_for_entries(entries)
                        avgs, _, _ = scannet_ap.evaluate_scannet(results,
                                                                 gt_ids)
                        score = avgs['all_ap_50%']
                        table.append((ths, score))
                        print(f'ths={ths} mAP50={score:.4f}')
                        if best is None or score > best[1]:
                            best = (ths, score)
        out = os.path.join(self.results_path, 'param_search.txt')
        with open(out, 'w') as f:
            for ths, score in table:
                f.write(f'{ths} {score}\n')
            f.write(f'best {best}\n')
        print(f'Best: ths={best[0]} mAP50={best[1]:.4f}')
        return best

    # ------------------------------------------------------------ submission
    def submission_write_out(self, dataset, out_dir=None):
        """ScanNet benchmark format: <scene>.txt lines
        'predicted_masks/<scene>_<j>.txt label conf' + 0/1 mask files
        (reference evaluation.py:617-650)."""
        if self._use_fused():
            results, _ = self.fused_dataset_results(dataset)
        else:
            results = self.pred_entries_to_results(
                self.load_or_predict(dataset))
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
