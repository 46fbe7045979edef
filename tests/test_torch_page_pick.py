"""Item 15c on the CPU: the serve scheduler's page size picked from the
tuned decode plans (``serve.pick_page_size``), against the JAX
package's pick, each package's entries in its own file and key format,
and the serve CLI at ``--page-size 0`` against an explicit page size."""
import pytest
import torch

from repro.launch import serve as jax_serve
from repro.tune import cache as jax_cache
from repro_torch.launch import serve
from repro_torch.tune import cache as tcache

torch.set_num_threads(1)
HEADS, HKV, HD, SLOTS = 8, 1, 256, 4
CPU = "cpu"


@pytest.fixture
def plan_files(tmp_path, monkeypatch):
    """Both packages' default caches at files of this test's own (JAX's
    default, ``results/tuned_plans.json``, holds decode entries)."""
    paths = tmp_path / "torch_plans.json", tmp_path / "jax_plans.json"
    monkeypatch.setenv(tcache.ENV, str(paths[0]))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(paths[1]))
    tcache.preload()
    jax_cache.preload()
    yield paths
    monkeypatch.undo()
    tcache.preload()
    jax_cache.preload()


def _write(paths, entries, max_len=8192):
    """Decode entries (page, us) into both caches: the port's key holds
    (n_pages, page, Hkv); JAX's (slots, heads, n_pages, page, hd) and a
    plan naming its ``page_size``."""
    ours, theirs = tcache.PlanCache(paths[0]), jax_cache.PlanCache(paths[1])
    for page, us in entries:
        n_pages = -(-max_len // page)
        ours.put("decode_attention", (n_pages, page, HKV), torch.bfloat16,
                 {"split_keys": 4 * page}, backend=CPU, us=us)
        theirs.put("decode_attention", (SLOTS, HEADS, n_pages, page, HD),
                   "bfloat16", {"page_size": page, "pages_per_tile": 2},
                   backend=CPU, us=us)
    # entries of other kernels and other cards are not decode plans here
    ours.put("decode_attention", (64, 128, HKV), torch.bfloat16,
             {"split_keys": 256}, backend="NVIDIA H100 80GB HBM3", us=0.5)
    ours.put("matmul", (2048, 2048), torch.bfloat16, {"split_k": 1},
             backend=CPU, us=0.1)
    ours.save()
    theirs.save()
    tcache.preload()
    jax_cache.preload()


def _picks():
    return serve.pick_page_size(CPU), jax_serve.pick_page_size(CPU)


def test_empty_cache_picks_the_default(plan_files):
    assert _picks() == (64, 64) == (serve.DEFAULT_PAGE_SIZE,
                                    jax_serve.DEFAULT_PAGE_SIZE)


@pytest.mark.parametrize("entries,want", [
    (((32, 10.0), (64, 12.0)), 32),
    (((32, 15.0), (64, 12.0)), 64),
    (((16, 9.0), (32, 11.0), (64, 12.0)), 16)])
def test_tuned_entries_pick_the_fastest_page(plan_files, entries, want):
    _write(plan_files, entries)
    assert _picks() == (want, want)


def _serve(page_size):
    return serve.main(["--arch", "gemma-2b", "--smoke", "--cache", "paged",
                       "--slots", "2", "--requests", "3", "--prompt-len",
                       "6", "--max-new", "3", "--max-len", "16",
                       "--page-size", str(page_size), "--device", "cpu"])


def test_served_problem_keeps_only_its_own_entries(plan_files):
    """The scheduler's pick compares only entries of its own (Hkv, pool
    dtype, table): a faster entry of another size does not steer it."""
    _write(plan_files, ((32, 10.0), (64, 12.0)))
    ours = tcache.PlanCache(plan_files[0]).load()
    for shape, dtype in (((8192 // 16, 16, 2 * HKV), torch.bfloat16),
                         ((8192 // 16, 16, HKV), torch.int8),
                         ((1024 // 16, 16, HKV), torch.bfloat16)):
        ours.put("decode_attention", shape, dtype, {"split_keys": 64},
                 backend=CPU, us=1.0)
    ours.save()
    tcache.preload()
    assert serve.pick_page_size(CPU) == 16
    assert serve.pick_page_size(CPU, hkv=HKV, dtype=torch.bfloat16,
                                max_len=8192) == 32
    assert serve.pick_page_size(CPU, hkv=3, dtype=torch.bfloat16,
                                max_len=8192) == serve.DEFAULT_PAGE_SIZE


def test_serve_cli_runs_at_the_picked_page(plan_files):
    # smoke gemma-2b: one kv head, bf16 pools, tables of ceil(16 / page)
    _write(plan_files, ((4, 10.0), (8, 12.0)), max_len=16)
    picked = _serve(0)
    assert picked["page_size"] == 4
    plan_files[0].unlink()
    tcache.preload()
    explicit = _serve(4)
    assert explicit["page_size"] == 4
    assert {r.rid: list(r.out) for r in picked["done"]} \
        == {r.rid: list(r.out) for r in explicit["done"]}
    assert _serve(0)["page_size"] == serve.DEFAULT_PAGE_SIZE
