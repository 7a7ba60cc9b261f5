"""Offline preprocessing: noisy/GT OBJ directories → ``.npz`` datasets
(the port's counterpart of ``facet_graph_convolution_tpu/data/preprocess.py``;
reference ``pickleData``, preprocess.py:7-58).

Each noisy mesh is added ``training_data_redundancy`` times (the randomized
patching and coarsening make each repeat another sample), one worker process
per mesh; with ``with_vertices`` through ``add_mesh_with_vertices``, whose
patches carry the vertex pipeline's fields. The sets are written in the JAX
package's ``.npz`` layout, so either package trains on them. Host code only:
NumPy and SciPy.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from facet_graph_convolution_torch.config import Config, default_config, gt_filename
from facet_graph_convolution_torch.data.dataset import TrainingSet, save_dataset
from facet_graph_convolution_torch.data.stream import save_sharded
from facet_graph_convolution_torch.geometry.obj_io import load_obj


def _process_one(task):
    """Worker: a one-mesh TrainingSet (picklable arguments only)."""
    noisy_dir, gt_dir, filename, cfg_kwargs, with_vertices, redundancy, seed = task
    ds = TrainingSet(seed=seed, **cfg_kwargs)
    vertices, faces, _ = load_obj(noisy_dir, filename)
    gt_vertices, _, _ = load_obj(gt_dir, gt_filename(filename))
    add = ds.add_mesh_with_vertices if with_vertices else ds.add_mesh
    for _ in range(redundancy):
        add(vertices, faces, gt_vertices)
    return filename, ds


def _build_set(noisy_dir: str, gt_dir: str, cfg: Config, with_vertices: bool,
               seed: Optional[int] = None, num_workers: Optional[int] = None) -> TrainingSet:
    """A training set from every OBJ of ``noisy_dir``, one process per mesh
    (mesh i is seeded ``seed + i``, as in the JAX package)."""
    cfg_kwargs = dict(
        max_patch_size=cfg.data.max_patch_size,
        coarsening_steps=cfg.model.coarsening_steps,
        coarsening_levels=cfg.model.coarsening_levels,
        k_faces=cfg.data.k_faces,
        k_vertices=cfg.data.k_vertices,
        max_edges=cfg.data.max_edges,
    )
    files = sorted(f for f in os.listdir(noisy_dir) if f.endswith(".obj"))
    base_seed = 0 if seed is None else seed
    tasks = [(noisy_dir, gt_dir, f, cfg_kwargs, with_vertices,
              cfg.data.training_data_redundancy, base_seed + i) for i, f in enumerate(files)]

    ds = TrainingSet(seed=base_seed, **cfg_kwargs)
    if num_workers is None:
        num_workers = min(len(tasks), os.cpu_count() or 1, 16)
    t0 = time.time()
    if num_workers > 1 and len(tasks) > 1:
        import concurrent.futures as cf
        import multiprocessing as mp

        # spawn: never fork a process that may hold CUDA or OpenMP threads
        with cf.ProcessPoolExecutor(max_workers=num_workers,
                                    mp_context=mp.get_context("spawn")) as pool:
            parts = list(pool.map(_process_one, tasks))
    else:
        parts = [_process_one(task) for task in tasks]
    for filename, part in parts:
        ds.patches.extend(part.patches)
        print(f"added {filename} ({len(part.patches)} patches)")
    print(f"built {len(ds.patches)} patches in {time.time() - t0:.2f}s "
          f"({num_workers} workers)")
    return ds


def preprocess_directory(cfg: Optional[Config] = None,
                         with_vertices: Optional[bool] = None,
                         shard_size: Optional[int] = None) -> None:
    """Build and save ``trainingSet.npz`` (and ``validSet.npz`` when the
    validation directory has meshes) under ``cfg.data.binary_dump_path``
    (reference ``pickleData``, preprocess.py:7-49); with ``with_vertices``
    (default ``cfg.model.include_vertices``), ``trainingSetWithVertices.npz``
    and ``validSetWithVertices.npz``. ``shard_size`` also writes the
    training set as streaming shards of that many patches
    (:func:`..data.stream.save_sharded`) into ``trainingShards{suffix}/``
    beside them, for ``cli.train --stream_dir``."""
    cfg = cfg or default_config()
    if with_vertices is None:
        with_vertices = cfg.model.include_vertices
    os.makedirs(cfg.data.binary_dump_path, exist_ok=True)
    suffix = "WithVertices" if with_vertices else ""

    train = _build_set(cfg.data.training_data_path, cfg.data.gt_data_path, cfg, with_vertices)
    train_path = os.path.join(cfg.data.binary_dump_path, f"trainingSet{suffix}.npz")
    save_dataset(train, train_path)
    print(f"saved {len(train.patches)} training patches → {train_path}")
    if shard_size:
        shard_dir = os.path.join(cfg.data.binary_dump_path, f"trainingShards{suffix}")
        n = save_sharded(train, shard_dir, patches_per_shard=shard_size)
        print(f"saved {n} streaming shards → {shard_dir}")

    if os.path.isdir(cfg.data.valid_data_path) and os.listdir(cfg.data.valid_data_path):
        valid = _build_set(cfg.data.valid_data_path, cfg.data.gt_data_path, cfg, with_vertices)
        valid_path = os.path.join(cfg.data.binary_dump_path, f"validSet{suffix}.npz")
        save_dataset(valid, valid_path)
        print(f"saved {len(valid.patches)} validation patches → {valid_path}")
