"""PyTorch port, multi-GPU building blocks on the CPU, each against the JAX
package: the mesh's shape and errors, the sharding plan, ring attention
over a 4-rank gloo group, and per-rank data shards.

Ranks are spawned processes (`spawn_ranks`: the `spawn` start method, one
torch thread each, a `FileStore` under the test's temporary directory for
the rendezvous, so parallel test workers never race for a port, and a
deadline after which the ranks are killed and the test fails). The
workers live in this module and import no JAX; JAX is imported inside the
tests and fixtures, and results come back as .npz files.

Tolerances: ring attention against JAX's `ring_attention` (both fp32 on
the CPU, JAX's flash kernels in interpret mode) and against plain causal
attention, 1e-5 absolute on o and on the q/k/v gradients (measured ~1e-6).
"""

import dataclasses
import json
import os
import random
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from metamorph_tpu_torch.config import MeshConfig

SPAWN_DEADLINE_S = 240


def _rank_main(rank, world, store_path, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, tmp_path, *args) -> None:
    """Run fn(rank, world, *args) in `world` spawned processes joined by a
    gloo group; raises if a rank fails or the deadline passes."""
    store = str(tmp_path / f"store_{time.monotonic_ns()}")
    ctx = mp.start_processes(_rank_main, args=(world, store, fn, args),
                             nprocs=world, start_method="spawn", join=False)
    deadline = time.monotonic() + SPAWN_DEADLINE_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} still "
                                   f"running after {SPAWN_DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

MESHES = [MeshConfig(1, -1, 1), MeshConfig(2, -1, 1), MeshConfig(2, 2, 2),
          MeshConfig(-1, 2, 1), MeshConfig(1, 2, -1), MeshConfig(8, 1, 1)]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shapes_and_errors_match_jax(n):
    import jax

    from metamorph_tpu.config import MeshConfig as JMeshConfig
    from metamorph_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from metamorph_tpu_torch.parallel.mesh import mesh_shape

    for cfg in MESHES + [MeshConfig(-1, -1, 1), MeshConfig(3, 1, 1)]:
        jcfg = JMeshConfig(cfg.data, cfg.fsdp, cfg.tensor)
        try:
            want = tuple(jax_build_mesh(jcfg, jax.devices()[:n])
                         .devices.shape)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                mesh_shape(cfg, n)
            assert str(got.value) == str(e)
            continue
        assert mesh_shape(cfg, n) == want
        assert cfg.device_count(n) == n


def test_one_rank_mesh_and_dp_coordinates():
    """build_mesh over a one-rank group, single_device_mesh, and the
    data-parallel coordinate of every rank of a (2, 2, 2) mesh layout."""
    from metamorph_tpu_torch.parallel import mesh as M

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = M.single_device_mesh("cpu")
        assert mesh.mesh_dim_names == M.AXES
        assert tuple(mesh.mesh.shape) == (1, 1, 1)
        assert M.dp_coordinate(mesh, False) == (0, 1)
        with pytest.raises(ValueError, match="does not cover 1 devices"):
            M.build_mesh(MeshConfig(2, 1, 1), "cpu")
        # a CUDA tensor on a gloo group raises (or, on a build without
        # NCCL, the missing NCCL does)
        with pytest.raises(RuntimeError, match="(?i)nccl"):
            M.check_backend(torch.device("cuda"))
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="needs a process group"):
        M.build_mesh(MeshConfig(1, 1, 1), "cpu")

    # the coordinate arithmetic on a (2, 2, 2) layout, rank r at the
    # row-major place r: tensor peers share a coordinate; under sequence
    # parallelism fsdp peers do too
    grid = torch.arange(8).reshape(2, 2, 2)
    for r in range(8):
        d, f, t = [int(i) for i in (grid == r).nonzero()[0]]
        fake = types.SimpleNamespace(
            mesh_dim_names=M.AXES, mesh=grid,
            get_local_rank=lambda a, c={"data": d, "fsdp": f,
                                        "tensor": t}: c[a])
        assert M.dp_coordinate(fake, False) == (d * 2 + f, 4)
        assert M.dp_coordinate(fake, True) == (d, 2)


# ---------------------------------------------------------------------------
# the sharding plan
# ---------------------------------------------------------------------------

# the port's name -> the JAX tree path (stacked layers: the leading L dim
# dropped from JAX's spec)
PLAN_NAMES = {
    "llama.layers.0.wq": ("llama/layers/attn/wq", True),
    "llama.layers.1.wv": ("llama/layers/attn/wv", True),
    "llama.layers.0.w_gate": ("llama/layers/mlp/w_gate", True),
    "llama.layers.1.w_up": ("llama/layers/mlp/w_up", True),
    "llama.layers.0.wo": ("llama/layers/attn/wo", True),
    "llama.layers.0.w_down": ("llama/layers/mlp/w_down", True),
    "llama.embed": ("llama/embed/embedding", False),
    "llama.lm_head": ("llama/lm_head/kernel", False),
    "llama.final_norm": ("llama/final_norm/scale", False),
    "llama.layers.0.input_norm": ("llama/layers/input_norm/scale", True),
    "projector.layers.0.kernel": ("projector/w0/kernel", False),
    "siglip.layers.0.fc1": ("siglip/layers/mlp/fc1/kernel", True),
}
# where the port deliberately differs from JAX's table (see
# parallel/sharding.py): FSDP2 cuts dim 0 of every parameter; the
# embedding, lm_head, SigLIP and the heads are not cut on tensor; the row
# products take both cuts on dim 0
DIFFERENT = {
    "llama.layers.0.wo": ((("tensor", "fsdp"), None), ("tensor", "fsdp")),
    "llama.layers.0.w_down": ((("tensor", "fsdp"), None), ("tensor", "fsdp")),
    "llama.embed": (("fsdp", None), ("tensor", "fsdp")),
    "llama.lm_head": (("fsdp", None), ("fsdp", "tensor")),
    "llama.final_norm": (("fsdp",), (None,)),
    "llama.layers.0.input_norm": (("fsdp",), (None,)),
    "projector.layers.0.kernel": (("fsdp", None), ("fsdp", "tensor")),
    "siglip.layers.0.fc1": (("fsdp", None), ("fsdp", "tensor")),
}


def _jax_leaf_specs(tree, mesh):
    import jax

    from metamorph_tpu.parallel.sharding import partition_specs

    specs = partition_specs(tree, mesh)
    out = {}
    for path, s in jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda x: type(x).__name__ == "PartitionSpec"):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = tuple(s)
    return out


def test_partition_specs_follow_jax_rules():
    """The port's placements on the tiny tree of a (1, 2, 2) mesh against
    JAX's `partition_specs`, equal wherever the port follows JAX's rule and
    as listed in DIFFERENT where it deliberately does not."""
    import jax
    import jax.numpy as jnp

    from metamorph_tpu.config import MeshConfig as JMeshConfig
    from metamorph_tpu.config import MetaMorphConfig as JConfig
    from metamorph_tpu.models import metamorph as JM
    from metamorph_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from metamorph_tpu_torch.config import MetaMorphConfig
    from metamorph_tpu_torch.models.metamorph import MetaMorph
    from metamorph_tpu_torch.parallel.sharding import partition_specs

    jcfg = JConfig.tiny()
    jtree = jax.eval_shape(lambda: JM.init_metamorph_params(
        jax.random.PRNGKey(0), jcfg, dtype=jnp.float32))
    jspecs = _jax_leaf_specs(jtree, jax_build_mesh(JMeshConfig(1, 2, 2),
                                                   jax.devices()[:4]))
    cfg = MetaMorphConfig.from_dict(jcfg.to_dict())
    model = MetaMorph(cfg, torch.float32, "meta")
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "fsdp", "tensor"),
                                 mesh=torch.zeros(1, 2, 2))
    mine = partition_specs(model, mesh)
    for name, (path, stacked) in PLAN_NAMES.items():
        want = jspecs[path][1:] if stacked else jspecs[path]
        want = want + (None,) * (len(mine[name]) - len(want))
        if name in DIFFERENT:
            port, jax_spec = DIFFERENT[name]
            assert mine[name] == port, name
            assert want == jax_spec, name
        else:
            assert mine[name] == want, name
    # an unsplittable tensor axis (3 does not divide 4 heads) leaves the
    # layers whole
    mesh3 = types.SimpleNamespace(mesh_dim_names=("data", "fsdp", "tensor"),
                                  mesh=torch.zeros(1, 1, 3))
    assert all("tensor" not in str(s)
               for s in partition_specs(model, mesh3).values())


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------

RING_SHAPES = {"T256_dh64": (1, 4 * 64, 4, 2, 64),
               "T128_dh32": (2, 4 * 32, 4, 2, 32)}


def _ring_inputs(shape, seed):
    B, T, H, KV, Dh = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, T, KV, Dh)).astype(np.float32)
    v = rng.normal(size=(B, T, KV, Dh)).astype(np.float32)
    w = rng.normal(size=(B, T, H, Dh)).astype(np.float32)   # the cotangent
    return q, k, v, w


IMPLS = ("xla", "flash", "ring")


def _ring_worker(rank, world, out_dir):
    from metamorph_tpu_torch.ops.attention import attention
    from metamorph_tpu_torch.parallel import context
    from metamorph_tpu_torch.parallel import mesh as M
    from metamorph_tpu_torch.parallel.ring_attention import ring_attention

    group = dist.new_group(list(range(world)))
    for key, shape in RING_SHAPES.items():
        q, k, v, w = (torch.from_numpy(x) for x in _ring_inputs(shape, 3))
        T_loc = shape[1] // world
        sl = slice(rank * T_loc, (rank + 1) * T_loc)

        def run(fn, name):
            ql, kl, vl = (x[:, sl].clone().requires_grad_()
                          for x in (q, k, v))
            o = fn(ql, kl, vl)
            (o * w[:, sl]).sum().backward()
            np.savez(os.path.join(out_dir, f"{name}_{rank}.npz"),
                     o=o.detach().numpy(), dq=ql.grad.numpy(),
                     dk=kl.grad.numpy(), dv=vl.grad.numpy())

        run(lambda *qkv: ring_attention(*qkv, group), key)
    # the models' entry point with the sequence axis of a (1, 4, 1) mesh
    # registered, as the sharded step registers it
    context.set_current_mesh(M.build_mesh(MeshConfig(1, world, 1), "cpu"))
    context.set_sequence_axis("fsdp")
    for impl in IMPLS:
        run(lambda *qkv: attention(*qkv, impl=impl), f"{key}_{impl}")


@pytest.fixture(scope="module")
def ring_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring")
    spawn_ranks(_ring_worker, 4, d, str(d))
    out = {}
    last = list(RING_SHAPES)[-1]
    for key in (*RING_SHAPES, *(f"{last}_{impl}" for impl in IMPLS)):
        parts = [np.load(d / f"{key}_{r}.npz") for r in range(4)]
        out[key] = {n: np.concatenate([p[n] for p in parts], axis=1)
                    for n in ("o", "dq", "dk", "dv")}
    return out


@pytest.mark.parametrize("key", list(RING_SHAPES))
def test_ring_attention_matches_jax_and_plain(ring_results, key):
    """4 gloo ranks, each holding T/4 positions, against JAX's
    `ring_attention` on a 4-device fsdp mesh and against plain causal
    attention over the whole sequence: o and the q/k/v gradients of
    sum(o * w)."""
    import jax

    from metamorph_tpu.config import MeshConfig as JMeshConfig
    from metamorph_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from metamorph_tpu.parallel.ring_attention import \
        ring_attention as jax_ring
    from metamorph_tpu_torch.ops.attention import (dot_product_attention,
                                                   make_causal_mask)

    shape = RING_SHAPES[key]
    q, k, v, w = _ring_inputs(shape, 3)
    mesh = jax_build_mesh(JMeshConfig(1, 4, 1), devices=jax.devices()[:4])
    blk = shape[1] // 4

    def jloss(q, k, v):
        o = jax_ring(q, k, v, mesh, axis_name="fsdp", block_q=blk,
                     block_k=blk)
        return (o * w).sum(), o

    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                             has_aux=True))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    mask = make_causal_mask(torch.ones(shape[0], shape[1], dtype=torch.int32))
    po = dot_product_attention(tq, tk, tv, mask=mask)
    (po * torch.from_numpy(w)).sum().backward()
    got = ring_results[key]
    for name, jref, pref in (("o", jo, po.detach()), ("dq", jg[0], tq.grad),
                             ("dk", jg[1], tk.grad), ("dv", jg[2], tv.grad)):
        np.testing.assert_allclose(got[name], np.asarray(jref), rtol=0,
                                   atol=1e-5, err_msg=f"{name} vs JAX")
        np.testing.assert_allclose(got[name], pref.numpy(), rtol=0,
                                   atol=1e-5, err_msg=f"{name} vs plain")


@pytest.mark.parametrize("impl", IMPLS)
def test_attention_is_the_ring_under_a_sequence_axis(ring_results, impl):
    """`attention(impl=...)` on 4 ranks that each hold T/4 positions, with
    the sequence axis registered: every impl is the ring, bit for bit, o
    and the q/k/v gradients (flash attention over a rank's own slice alone
    would drop the keys of the earlier ranks)."""
    last = list(RING_SHAPES)[-1]
    ring, got = ring_results[last], ring_results[f"{last}_{impl}"]
    for name in ("o", "dq", "dk", "dv"):
        assert np.array_equal(got[name], ring[name]), name


def test_ring_positions_in_one_process_match_the_group():
    """`_ring_body` fed from a list of chunks (how one card runs every
    position of a ring in turn) gives each position's o and gradients of
    the whole-sequence causal attention; a skipped chunk launches nothing
    (the plain flash version is called once per unskipped chunk)."""
    from metamorph_tpu_torch.ops import flash_attention as FA
    from metamorph_tpu_torch.ops.attention import (dot_product_attention,
                                                   make_causal_mask)
    from metamorph_tpu_torch.parallel import ring_attention as R

    shape = RING_SHAPES["T128_dh32"]
    n = 4
    q, k, v, w = (torch.from_numpy(x) for x in _ring_inputs(shape, 5))
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    mask = make_causal_mask(torch.ones(shape[0], shape[1], dtype=torch.int32))
    (dot_product_attention(tq, tk, tv, mask=mask) * w).sum().backward()
    calls = []
    real = FA.flash_attention_plain

    def counted(*a, **kw):
        calls.append(a[4] if len(a) > 4 else kw.get("causal"))
        return real(*a, **kw)

    FA.flash_attention_plain = counted
    try:
        T_loc = shape[1] // n
        kt = [k[:, i * T_loc:(i + 1) * T_loc].transpose(1, 2)
              .clone().requires_grad_() for i in range(n)]
        vt = [v[:, i * T_loc:(i + 1) * T_loc].transpose(1, 2)
              .clone().requires_grad_() for i in range(n)]
        dq = []
        for idx in range(n):
            sl = slice(idx * T_loc, (idx + 1) * T_loc)
            ql = q[:, sl].transpose(1, 2).clone().requires_grad_()
            o, _ = R._ring_body(ql, idx, n,
                                R.chunks_source(kt, vt, idx, torch.float32))
            ref = dot_product_attention(q, k, v, mask=mask)[:, sl]
            np.testing.assert_allclose(o.transpose(1, 2).detach().numpy(),
                                       ref.numpy(), rtol=0, atol=1e-5)
            (o.transpose(1, 2) * w[:, sl]).sum().backward()
            dq.append(ql.grad.transpose(1, 2))
    finally:
        FA.flash_attention_plain = real
    # position idx runs its diagonal and idx full chunks: 1 + 2 + 3 + 4
    assert calls.count(True) == n and calls.count(False) == n * (n - 1) // 2
    np.testing.assert_allclose(torch.cat(dq, 1).numpy(), tq.grad.numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(torch.cat([x.grad.transpose(1, 2) for x in kt],
                                         1).numpy(), tk.grad.numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(torch.cat([x.grad.transpose(1, 2) for x in vt],
                                         1).numpy(), tv.grad.numpy(),
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# per-rank data shards
# ---------------------------------------------------------------------------

WORDS = ["red", "cat", "sat", "on", "a", "mat", "the", "dog", "ran", "far",
         "blue", "sky", "over", "hill"]


@pytest.fixture(scope="module")
def shard_jsonl(tmp_path_factory):
    """12 image rows (every third with an answer image) and 4 text rows."""
    from PIL import Image

    d = tmp_path_factory.mktemp("shards")
    rng = random.Random(4)
    img = d / "m.png"
    Image.fromarray(np.random.default_rng(4).integers(
        0, 256, (30, 44, 3)).astype(np.uint8)).save(img)

    def text(lo, hi):
        return " ".join(rng.choice(WORDS) for _ in range(rng.randint(lo, hi)))

    rows = []
    for i in range(12):
        answer = " <image> " if i % 3 == 0 else " "
        rows.append({"id": f"img{i}",
                     "image": [str(img)] * (2 if answer.strip() else 1),
                     "conversations": [
                         {"from": "human", "value": "<image>\n" + text(1, 8)},
                         {"from": "gpt", "value": text(1, 6) + answer + "ok"}]})
    for i in range(4):
        rows.append({"id": f"txt{i}", "image": None, "conversations": [
            {"from": "human", "value": text(2, 9)},
            {"from": "gpt", "value": text(1, 7)}]})
    random.Random(5).shuffle(rows)
    path = d / "rows.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return str(path)


def _data_pair(path, **it_kw):
    from metamorph_tpu.train import data as JD
    from metamorph_tpu_torch.train import data as D
    from tests.test_masking import fake_tokenize

    out = []
    for mod in (D, JD):
        cfg = mod.DataConfig(data_path=path, image_size=28)
        ds = mod.LazySupervisedDataset(path, fake_tokenize, cfg, seed=1)
        col = mod.PackedCollator(num_image_tokens=4, max_seq_len=48,
                                 num_image_slots=8, image_size=28)
        out.append(mod.DataIterator(ds, col, 4, seed=2, **it_kw))
    return out


@pytest.mark.parametrize("P", [2, 4])
def test_rank_shards_match_jax_process_shards(shard_jsonl, monkeypatch, P):
    """Rank r's packed shard and pixels equal JAX's
    DataIterator(process_index=r, process_count=P) over three batches,
    JAX's re-basing to the global image table undone (the port keeps each
    shard's local numbering: the dummy row is the local N/P * K)."""
    from metamorph_tpu.multimodal import native as JN

    monkeypatch.setattr(JN, "_load", lambda: None)
    K, N = 4, 8
    for r in range(P):
        mine, ref = _data_pair(shard_jsonl, process_index=r,
                               process_count=P)
        for (pm, xm), (pr, xr) in zip(
                (b for _, b in zip(range(3), iter(mine))),
                (b for _, b in zip(range(3), iter(ref)))):
            base = r * (N // P) * K
            local = np.where(pr.is_image, pr.img_gather_idx - base,
                             (N // P) * K)
            for f in dataclasses.fields(pm):
                a, b = getattr(pm, f.name), getattr(pr, f.name)
                if f.name == "img_gather_idx":
                    b = local
                if a is None:
                    assert b is None, f.name
                    continue
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            np.testing.assert_array_equal(xm, xr)
        assert mine.state_dict() == ref.state_dict()


def test_rank_shards_fuse_to_the_global_batch(shard_jsonl, monkeypatch):
    """The ranks' fused embeddings (each from its own shard and its own
    images), concatenated over P = 2, equal the one-process batch's (JAX's
    tests/test_data.py statement for its process shards)."""
    from metamorph_tpu.multimodal import native as JN
    from metamorph_tpu_torch.config import (LlamaConfig, MetaMorphConfig,
                                            MultimodalConfig, SiglipConfig)
    from metamorph_tpu_torch.convert import init_params
    from metamorph_tpu_torch.models import metamorph as M
    from metamorph_tpu_torch.multimodal.packing import batch_to_arrays

    monkeypatch.setattr(JN, "_load", lambda: None)
    # the fake tokenizer's specials sit at 200000+
    cfg = MetaMorphConfig(llama=LlamaConfig.tiny(vocab_size=200064),
                          siglip=SiglipConfig.tiny(),
                          mm=MultimodalConfig(num_image_tokens=4))
    model = init_params(cfg, seed=1, device="cpu", dtype=torch.float32)

    def fused(packed, pixels):
        b = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in batch_to_arrays(packed).items()}
        with torch.no_grad():
            projected, _ = M.encode_images(model, cfg,
                                           torch.from_numpy(pixels))
            return M.fuse_embeddings(model, cfg, b, projected)

    whole, _ = _data_pair(shard_jsonl)
    shards = [_data_pair(shard_jsonl, process_index=r, process_count=2)[0]
              for r in range(2)]
    for g, *parts in zip((b for _, b in zip(range(2), iter(whole))),
                         *(iter(s) for s in shards)):
        cat = torch.cat([fused(*p) for p in parts])
        np.testing.assert_allclose(cat.numpy(), fused(*g).numpy(), rtol=0,
                                   atol=1e-6)
