"""The port's scenario subsystem on the CPU: the cases of
``tests/test_scenario.py`` against ``repro_torch``, plus parity with the
JAX package.

Invariants (tolerance 0 throughout — every check is bitwise or exact):
  * a hot-swapped branch gives exactly the bits of a freshly built cell
    on ``combine(branch, trunk)``, for all four CNN trunks, and the trunk
    tensors are the very same objects after the swap;
  * a swap is a FIFO barrier: each LM request decodes entirely under the
    scenario it was submitted with, and its tokens equal both its solo
    decode in the port and the JAX package's solo decode on the same
    converted parameters;
  * the ScenarioStore's device cache evicts in LRU order;
  * ``plan_fingerprint`` is the JAX package's hex for the same plan;
  * a branch never crosses a placement: plan-fingerprint and geometry
    mismatches are refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import plan as jplan
from repro import scenario as jscenario
from repro.checkpoint import manager as jckpt
from repro.core import rebranch as jrebranch
from repro.models import cnn as jcnn
from repro.serve import registry as jregistry
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch import deploy
from repro_torch import plan as tplan
from repro_torch import scenario
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import rebranch
from repro_torch.models import cnn
from repro_torch.scenario import ScenarioStore
from repro_torch.serve import registry, server
from repro_torch.serve.pool import SlotPool
from repro_torch.serve.scheduler import ContinuousBatcher

LM_ID = "gemma-2b-smoke"
MAX_LEN = 48
CNN_TRUNKS = ("vgg8", "resnet18", "darknet19", "tiny_yolo")


def _copy(tree):
    return bridge.tree_map(tree, torch.clone)


def _perturb(branch, salt=1):
    """A distinct but compatible scenario branch (the reference's)."""
    return bridge.tree_map(
        branch, lambda t: t + 0.01 * salt if t.is_floating_point() else t)


def _with_cores(tree, gen):
    if isinstance(tree, dict):
        out = {k: _with_cores(v, gen) for k, v in tree.items()}
        if "core" in out.get("sram", {}):
            core = out["sram"]["core"]
            out["sram"]["core"] = torch.randn(core.shape, generator=gen) * 0.05
        return out
    if isinstance(tree, list):
        return [_with_cores(v, gen) for v in tree]
    return tree


def _cell(name="vgg8", size=16, engine=None):
    cfg = cnn.CNNConfig(name=name, input_size=size)
    plan = tplan.solve(cfg, engine=engine)
    model = deploy.compile_model(cfg, plan=plan)
    params = _with_cores(model.init(0, device="cpu"),
                         torch.Generator().manual_seed(1))
    return model, plan, params


@pytest.fixture(scope="module")
def vgg_cell():
    return _cell()


def _images(n, size, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32))


def _forward(model, params, x):
    with torch.no_grad():
        return model.forward(params, x)


# ---------------------------------------------------------------------------
# branch extraction / validation / fingerprints
# ---------------------------------------------------------------------------

class TestBranch:
    def test_split_combine_roundtrip(self, vgg_cell):
        _, _, params = vgg_cell
        branch, trunk = scenario.split_params(params)
        rebuilt = rebranch.combine(branch, trunk)
        for (k, a), (k2, b) in zip(bridge.flatten(params).items(),
                                   bridge.flatten(rebuilt).items()):
            assert k == k2 and a is b

    def test_plan_fingerprint_stable_and_discriminating(self, vgg_cell):
        _, plan, _ = vgg_cell
        fp = scenario.plan_fingerprint(plan)
        assert fp == scenario.plan_fingerprint(plan)
        assert scenario.plan_fingerprint(None) == "no-plan" != fp
        other = tplan.solve(cnn.CNNConfig(
            name="vgg8", input_size=16,
            rebranch=rebranch.ReBranchSpec(d_ratio=8)))
        assert scenario.plan_fingerprint(other) != fp

    @pytest.mark.parametrize("name", CNN_TRUNKS)
    @pytest.mark.parametrize("engine", [None, "pallas_fused"])
    def test_plan_fingerprint_equal_across_packages(self, name, engine):
        """Plans solved by each package hash to the same hex, at the
        all-ROM point and at a budget that flips sites to SRAM."""
        jcfg = jcnn.CNNConfig(name=name, input_size=416)
        tcfg = cnn.CNNConfig(name=name, input_size=416)
        for rec in jplan.sweep(jcfg, 3)[:2]:
            budget = rec["budget_mm2"] * 1.2
            assert scenario.plan_fingerprint(
                tplan.solve(tcfg, budget, engine=engine)) == \
                jscenario.plan_fingerprint(
                    jplan.solve(jcfg, budget, engine=engine))

    @pytest.mark.parametrize("engine", [None, "pallas_fused"])
    def test_plan_fingerprint_equal_for_gemma_2b(self, engine):
        for get_t, get_j in ((tconfigs.get, jconfigs.get),
                             (tconfigs.get_smoke, jconfigs.get_smoke)):
            assert scenario.plan_fingerprint(
                tplan.solve(get_t("gemma_2b"), engine=engine)) == \
                jscenario.plan_fingerprint(
                    jplan.solve(get_j("gemma_2b"), engine=engine))

    def test_branch_template_allocates_nothing(self):
        """Full-width Gemma-2B: a meta-tensor skeleton, no storage."""
        model = deploy.compile_model(tconfigs.get("gemma_2b"))
        template = scenario.branch_template(model)
        leaves = bridge.flatten(template)
        assert leaves and all(t.device.type == "meta"
                              for t in leaves.values())
        cores = [k for k in leaves if k.endswith("['core']")]
        assert len(cores) == 7 and leaves[cores[0]].shape[0] == 18

    def test_validate_missing_and_unexpected(self, vgg_cell):
        model, _, _ = vgg_cell
        bare = deploy.compile_model(cnn.CNNConfig(
            name="vgg8", input_size=16,
            rebranch=rebranch.ReBranchSpec(branch_enabled=False)))
        small = rebranch.partition(bare.init(1, device="cpu"))[0]
        with pytest.raises(ValueError, match="missing tensors"):
            scenario.validate_branch(small, scenario.branch_template(model))
        full = rebranch.partition(model.init(1, device="cpu"))[0]
        with pytest.raises(ValueError, match="unexpected tensors"):
            scenario.validate_branch(full, scenario.branch_template(bare))

    def test_validate_shape_and_dtype_mismatch(self, vgg_cell):
        model, _, params = vgg_cell
        template = scenario.branch_template(model)
        bad = _copy(rebranch.partition(params)[0])
        bad["fc"]["sram"]["b"] = torch.zeros(3, 3)
        with pytest.raises(ValueError, match=r"\(3, 3\)"):
            scenario.validate_branch(bad, template)
        bad["fc"]["sram"]["b"] = torch.zeros(100, dtype=torch.float64)
        with pytest.raises(ValueError, match="dtype float64"):
            scenario.validate_branch(bad, template)

    def test_extract_implant_roundtrip(self, vgg_cell):
        model, plan, params = vgg_cell
        branch, trunk = scenario.split_params(params)
        bundle = scenario.extract(
            model, rebranch.combine(_perturb(branch), trunk), plan)
        out = scenario.implant(model, params, bundle, plan, donate=False)
        ref = rebranch.combine(bundle.params, trunk)
        x = _images(2, 16)
        assert torch.equal(_forward(model, out, x), _forward(model, ref, x))

    def test_implant_rejects_plan_and_model_mismatch(self, vgg_cell):
        model, plan, params = vgg_cell
        bundle = scenario.extract(model, params, plan)
        with pytest.raises(ValueError, match="placement plan"):
            scenario.implant(model, params, bundle, None)
        wrong = scenario.BranchBundle(model="resnet18",
                                      plan_fp=bundle.plan_fp,
                                      params=bundle.params)
        with pytest.raises(ValueError, match="resnet18"):
            scenario.implant(model, params, wrong, plan)


# ---------------------------------------------------------------------------
# hot-swap bit-parity: every CNN trunk
# ---------------------------------------------------------------------------

class TestSwapParity:
    @pytest.mark.parametrize("name", CNN_TRUNKS)
    def test_swap_matches_freshly_built_cell(self, name):
        """Swapping branch B onto a resident trunk gives exactly the bits
        of a new cell on combine(B, trunk); the trunk tensors are the same
        objects after the swap, and the old tree is untouched."""
        size = 64 if name == "tiny_yolo" else 32
        model, plan, pA = _cell(name, size, engine="pallas_fused")
        brB = _perturb(scenario.split_params(pA)[0], salt=3)
        before = {k: v.clone() for k, v in bridge.flatten(pA).items()}
        swapped = scenario.swap_params(pA, brB)
        fresh_model = deploy.compile_model(model.cfg, plan=plan)
        fresh = rebranch.combine(_copy(brB), _copy(
            scenario.split_params(pA)[1]))
        srv = server.CNNServer(fresh_model, fresh, n_slots=2)
        x = _images(3, size, seed=1)
        assert np.array_equal(
            _forward(model, swapped, x).numpy(), srv.submit(x.numpy()))
        trunk_in = bridge.flatten(scenario.split_params(pA)[1])
        trunk_out = bridge.flatten(scenario.split_params(swapped)[1])
        assert trunk_in.keys() == trunk_out.keys()
        assert all(trunk_out[k] is v for k, v in trunk_in.items())
        for k, v in bridge.flatten(pA).items():      # nothing written
            assert torch.equal(v, before[k]), k
        branch_out = bridge.flatten(scenario.split_params(swapped)[0])
        assert all(branch_out[k] is v
                   for k, v in bridge.flatten(brB).items())

    def test_swap_copy_shares_nothing(self, vgg_cell):
        _, _, params = vgg_cell
        brB = _perturb(scenario.split_params(params)[0], salt=2)
        out = scenario.swap_params(params, brB, donate=False)
        ids = {id(t) for t in bridge.flatten(params).values()} | \
            {id(t) for t in bridge.flatten(brB).values()}
        assert not ids & {id(t) for t in bridge.flatten(out).values()}
        want = bridge.flatten(rebranch.combine(
            brB, scenario.split_params(params)[1]))
        for k, t in bridge.flatten(out).items():
            assert torch.equal(t, want[k]), k

    def test_cnn_server_swap_reuses_model(self, vgg_cell):
        model, plan, params = vgg_cell
        store = ScenarioStore(model, plan, capacity=2, device="cpu")
        base = scenario.split_params(params)[0]
        store.register("a", branch=_perturb(base, 1))
        store.register("b", branch=_perturb(base, 2))
        srv = server.CNNServer(model, params, n_slots=2, store=store)
        trunk = bridge.flatten(scenario.split_params(params)[1])
        x = _images(3, 16, seed=4).numpy()
        for name in ("a", "b", "a"):
            srv.swap_scenario(name)
            assert srv.scenario == name and srv.model is model
            now = bridge.flatten(scenario.split_params(srv.params)[1])
            assert all(now[k] is v for k, v in trunk.items())
            ref = rebranch.combine(store.get(name),
                                   scenario.split_params(params)[1])
            assert np.array_equal(srv.submit(x), server.CNNServer(
                deploy.compile_model(model.cfg, plan=plan), ref,
                n_slots=2).submit(x))


# ---------------------------------------------------------------------------
# ScenarioStore: strict names + LRU device cache
# ---------------------------------------------------------------------------

class TestStore:
    def _store(self, vgg_cell, capacity=2, n=3):
        model, plan, params = vgg_cell
        store = ScenarioStore(model, plan, capacity=capacity, device="cpu")
        base = scenario.split_params(params)[0]
        for i in range(n):
            store.register(f"s{i}", branch=_perturb(base, salt=i + 1))
        return store

    def test_lru_eviction_order(self, vgg_cell):
        store = self._store(vgg_cell, capacity=2, n=3)
        store.get("s0")
        store.get("s1")
        assert store.cached() == ["s0", "s1"]
        store.get("s2")                      # evicts s0 (LRU)
        assert store.cached() == ["s1", "s2"]
        store.get("s1")                      # hit: s1 becomes MRU
        store.get("s0")                      # reload: evicts s2, not s1
        assert store.cached() == ["s1", "s0"]
        assert store.evicted == ["s0", "s2"]
        assert store.hits == 1 and store.misses == 4
        store.evict("s1")
        assert store.cached() == ["s0"]
        store.evict()
        assert store.cached() == [] and len(store) == 3

    def test_unknown_scenario_lists_registered(self, vgg_cell):
        store = self._store(vgg_cell)
        with pytest.raises(KeyError, match=r"s0.*s1.*s2"):
            store.get("nope")

    def test_duplicate_register_needs_override(self, vgg_cell):
        store = self._store(vgg_cell)
        base = scenario.split_params(vgg_cell[2])[0]
        with pytest.raises(ValueError, match="already registered"):
            store.register("s0", branch=base)
        store.register("s0", branch=base, override=True)

    def test_host_snapshot_isolates_the_caller(self, vgg_cell):
        model, plan, params = vgg_cell
        store = ScenarioStore(model, plan, device="cpu")
        branch = _copy(scenario.split_params(params)[0])
        store.register("x", branch=branch)
        want = branch["fc"]["sram"]["b"].clone()
        branch["fc"]["sram"]["b"] += 5.0           # the caller's copy moves
        got = store.get("x")
        assert torch.equal(got["fc"]["sram"]["b"], want)
        assert got["fc"]["sram"]["b"] is not branch["fc"]["sram"]["b"]

    def test_bundle_mismatches_rejected(self, vgg_cell):
        model, plan, params = vgg_cell
        store = ScenarioStore(model, plan, device="cpu")
        branch = scenario.split_params(params)[0]
        with pytest.raises(ValueError, match="mismatched placement"):
            store.register("x", bundle=scenario.BranchBundle(
                model="vgg8", plan_fp="deadbeefdeadbeef", params=branch))
        with pytest.raises(ValueError, match="resnet18"):
            store.register("x", bundle=scenario.BranchBundle(
                model="resnet18", plan_fp=store.plan_fp, params=branch))
        store.register("ok", bundle=scenario.extract(model, params, plan))
        assert "ok" in store

    def test_exactly_one_source(self, vgg_cell):
        model, plan, _ = vgg_cell
        store = ScenarioStore(model, plan, device="cpu")
        with pytest.raises(ValueError, match="exactly one"):
            store.register("x")

    def test_store_serves_from_checkpoint_sources(self, vgg_cell, tmp_path):
        """A branch checkpoint written by the port and one written by the
        JAX package both serve from the store, bit for bit; a checkpoint
        of another placement is refused at load."""
        model, plan, params = vgg_cell
        branch = _perturb(scenario.split_params(params)[0], salt=7)
        ckpt.save_branch(str(tmp_path), "cold", branch,
                         model_name="vgg8", plan=plan)
        jcfg = jcnn.CNNConfig(name="vgg8", input_size=16)
        jckpt.save_branch(str(tmp_path), "jax", bridge.to_numpy(branch),
                          model_name="vgg8", plan=jplan.solve(jcfg))
        ckpt.save_branch(str(tmp_path), "other", branch, model_name="vgg8",
                         plan=None)
        store = ScenarioStore(model, plan, capacity=1, device="cpu")
        for name in ("cold", "jax", "other"):
            store.register(name, ckpt_dir=str(tmp_path))
        for name in ("cold", "jax", "cold"):
            got = bridge.flatten(store.get(name))
            for k, v in bridge.flatten(branch).items():
                assert torch.equal(got[k], v), (name, k)
        assert store.evicted == ["cold", "jax"] and store.misses == 3
        with pytest.raises(ValueError, match="mismatched placement"):
            store.get("other")


# ---------------------------------------------------------------------------
# scheduler: swap barrier + mixed-scenario isolation (LM decode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_cell():
    """Gemma-2B smoke: JAX-drawn parameters with seeded cores (numpy),
    the port's cell, and the JAX cell."""
    jmodel, _ = jregistry.compile_entry(LM_ID)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)

    def cores(tree):
        if isinstance(tree, dict):
            out = {k: cores(v) for k, v in tree.items()}
            if "core" in out.get("sram", {}):
                out["sram"]["core"] = (rng.normal(
                    size=out["sram"]["core"].shape) * 0.3).astype(np.float32)
            return out
        return tree

    model, plan = registry.compile_entry(LM_ID)
    return model, plan, jmodel, cores(params)


def _solo(model, params, prompt, n_new):
    cache = model.init_cache(1, MAX_LEN, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        logits, cache = model.prefill(
            params, {"tokens": torch.as_tensor(np.asarray(prompt)[None])},
            cache)
        out = [int(logits[0, -1].argmax())]
        for _ in range(n_new - 1):
            logits, cache = model.decode_step(
                params, torch.tensor([[out[-1]]]), cache)
            out.append(int(logits[0, -1].argmax()))
    return out


def _jax_solo(jmodel, params, prompt, n_new):
    cache = jmodel.init_cache(1, MAX_LEN, dtype=jnp.float32)
    logits, cache = jmodel.prefill(
        params, {"tokens": jnp.asarray(np.asarray(prompt)[None])}, cache)
    out = [int(jnp.argmax(logits[0, -1]))]
    for _ in range(n_new - 1):
        logits, cache = jmodel.decode_step(
            params, jnp.asarray([[out[-1]]], jnp.int32), cache)
        out.append(int(jnp.argmax(logits[0, -1])))
    return out


class TestSchedulerSwap:
    def test_mixed_scenario_batched_decode_isolation(self, lm_cell):
        """r1 admitted under A, swap queued, r2 under B: each equals its
        solo decode under its own parameters in the port AND the JAX
        package's solo decode on the same parameters; the swap applies
        only after r1 retires; the trunk tensors stay the same objects."""
        model, _, jmodel, npA = lm_cell
        jbrB = jax.tree.map(lambda x: x + np.float32(0.02),
                            jrebranch.partition(npA)[0])
        npB = jrebranch.combine(jbrB, jrebranch.partition(npA)[1])
        pA = bridge.to_torch(npA, "cpu")
        brB = bridge.to_torch(jbrB, "cpu")
        pB = rebranch.combine(brB, rebranch.partition(pA)[1])
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, 512, size=n) for n in (7, 5, 9, 4)]
        pool = SlotPool(model, 2, MAX_LEN, device="cpu")
        b = ContinuousBatcher(model, pA, pool, scenario="a")
        trunk = bridge.flatten(rebranch.partition(pA)[1])
        r1 = b.submit(prompts[0], 6, scenario="a")
        r2 = b.submit(prompts[1], 3)
        b.step()                              # r1, r2 admitted and decoding
        b.swap("b", brB)
        r3 = b.submit(prompts[2], 4, scenario="b")
        r4 = b.submit(prompts[3], 5)
        assert b.scenario == "a" and b.queued == 2
        b.drain(max_steps=100)
        assert b.swap_count == 1 and b.scenario == "b"
        assert (r1.scenario, r2.scenario, r3.scenario, r4.scenario) == \
            ("a", "a", "b", "b")
        assert min(r3.admit_step, r4.admit_step) >= \
            max(r1.finish_step, r2.finish_step)   # waited for the barrier
        now = bridge.flatten(rebranch.partition(b.params)[1])
        assert all(now[k] is v for k, v in trunk.items())
        for req, params, nparams, prompt in (
                (r1, pA, npA, prompts[0]), (r2, pA, npA, prompts[1]),
                (r3, pB, npB, prompts[2]), (r4, pB, npB, prompts[3])):
            n = req.max_new_tokens
            assert req.tokens == _solo(model, params, prompt, n)
            assert req.tokens == _jax_solo(jmodel, nparams, prompt, n)

    def test_submit_mismatched_scenario_requires_swap(self, lm_cell):
        model, _, _, npA = lm_cell
        b = ContinuousBatcher(model, bridge.to_torch(npA, "cpu"),
                              SlotPool(model, 1, MAX_LEN, device="cpu"),
                              scenario="a")
        with pytest.raises(ValueError, match="queue tail runs"):
            b.submit([1, 2, 3], 2, scenario="b")

    def test_pending_scenario_tracks_queue_tail(self, lm_cell):
        model, _, _, npA = lm_cell
        pA = bridge.to_torch(npA, "cpu")
        b = ContinuousBatcher(model, pA,
                              SlotPool(model, 1, MAX_LEN, device="cpu"),
                              scenario="a")
        assert b.pending_scenario() == "a"
        b.swap("b", _perturb(rebranch.partition(pA)[0]))
        assert b.pending_scenario() == "b" and b.scenario == "a"
        b.step()                              # nothing in flight: applies
        assert b.scenario == "b" and b.swap_count == 1 and b.idle

    def test_spec_k_and_prefill_chunk_still_raise(self, lm_cell):
        """What the batcher still refuses, now that both are ported: a
        negative ``spec_k`` (the reference's text)."""
        model, _, _, _ = lm_cell
        pool = SlotPool(model, 1, MAX_LEN, device="cpu")
        with pytest.raises(ValueError, match="spec_k must be >= 0"):
            ContinuousBatcher(model, {}, pool, spec_k=-1)
        assert ContinuousBatcher(model, {}, pool, spec_k=2,
                                 prefill_chunk=8).prefill_chunk == 8

    def test_swap_barrier_waits_for_chunked_prefill_and_spec_rounds(
            self, lm_cell):
        """A swap queued behind a chunk-prefilling request holds through
        its chunks and its speculative rounds (``prefill_chunk=2``,
        ``spec_k=2``, the branch drafter); the request finishes under A
        and the one behind the barrier decodes under B, each equal to its
        solo decode in both packages."""
        model, _, jmodel, npA = lm_cell
        pA = bridge.to_torch(npA, "cpu")
        brB = _perturb(rebranch.partition(pA)[0], 2)
        pB = rebranch.combine(brB, rebranch.partition(pA)[1])
        npB = bridge.to_numpy(pB)
        b = ContinuousBatcher(model, pA,
                              SlotPool(model, 2, MAX_LEN, device="cpu"),
                              scenario="a", prefill_chunk=2, spec_k=2)
        rng = np.random.default_rng(14)
        pr = [rng.integers(0, 512, size=n) for n in (7, 5)]
        r1 = b.submit(pr[0], 6, scenario="a")
        b.step()                               # the first chunk only
        assert b.prefilling and b.active == 0
        b.swap("b", brB)
        r2 = b.submit(pr[1], 5, scenario="b")
        while not r1.done:
            b.step()
            assert b.scenario == "a" and r2.admit_step < 0
        assert b.spec_rounds > 0
        b.drain(max_steps=100)
        assert b.scenario == "b" and b.swap_count == 1
        assert r2.admit_step >= r1.finish_step
        assert r1.tokens == _solo(model, pA, pr[0], 6) == \
            _jax_solo(jmodel, npA, pr[0], 6)
        assert r2.tokens == _solo(model, pB, pr[1], 5) == \
            _jax_solo(jmodel, npB, pr[1], 5)

    def test_lm_server_submit_with_scenario_swaps(self, lm_cell):
        """LMServer.submit(..., scenario=) queues the swap through the
        store; requests on both sides equal their solo decodes."""
        model, plan, _, npA = lm_cell
        pA = bridge.to_torch(npA, "cpu")
        store = ScenarioStore(model, plan, device="cpu")
        base = rebranch.partition(pA)[0]
        store.register("a", branch=base)
        store.register("b", branch=_perturb(base, 3))
        srv = server.LMServer(model, pA, n_slots=2, max_len=MAX_LEN,
                              store=store, scenario="a")
        rng = np.random.default_rng(8)
        pr = [rng.integers(0, 512, size=n) for n in (6, 8)]
        ra = srv.submit(pr[0], 4, scenario="a")
        rb = srv.submit(pr[1], 4, scenario="b")
        srv.drain(max_steps=50)
        assert srv.scenario == "b" and srv.batcher.swap_count == 1
        trunk = rebranch.partition(pA)[1]
        assert ra.tokens == _solo(model, pA, pr[0], 4)
        assert rb.tokens == _solo(
            model, rebranch.combine(store.get("b"), trunk), pr[1], 4)


# ---------------------------------------------------------------------------
# registry + front door integration
# ---------------------------------------------------------------------------

class TestRegistryScenarios:
    def test_entry_scenarios_seed_the_store_and_serve(self):
        cfg = cnn.CNNConfig(name="vgg8", input_size=16)
        plan = tplan.solve(cfg)

        def factory(model, plan):
            return _perturb(scenario.split_params(
                model.init(3, device="cpu"))[0], salt=4)

        registry.register(registry.ModelEntry(
            "vgg8-scn-test", config=lambda: cfg, plan=lambda c: plan,
            scenarios=(("alt", factory),)), override=True)
        assert registry.has_scenarios("vgg8-scn-test")
        model, _ = registry.compile_entry("vgg8-scn-test")
        params = model.init(0, device="cpu")
        srv = server.load("vgg8-scn-test", params=params, n_slots=2,
                          scenario="alt")
        assert isinstance(srv, server.CNNServer) and srv.scenario == "alt"
        store = registry.scenario_store("vgg8-scn-test")
        assert srv.store is store and store.device == torch.device("cpu")
        ref = rebranch.combine(store.get("alt"),
                               rebranch.partition(params)[1])
        x = _images(2, 16, seed=2)
        assert np.array_equal(srv.submit(x.numpy()),
                              _forward(model, ref, x).numpy())

    def test_swap_scenario_without_store_raises(self, vgg_cell):
        model, _, params = vgg_cell
        srv = server.CNNServer(model, params, n_slots=2)
        with pytest.raises(ValueError, match="no ScenarioStore"):
            srv.swap_scenario("x")
        lm, _ = registry.compile_entry(LM_ID)
        lsrv = server.LMServer(lm, lm.init(0, device="cpu"), n_slots=1,
                               max_len=MAX_LEN)
        with pytest.raises(ValueError, match="no ScenarioStore"):
            lsrv.swap_scenario("x")

    def test_reregister_invalidates_cell_and_store(self):
        registry.register(registry.ModelEntry(
            "vgg8-rereg-test",
            config=lambda: cnn.CNNConfig(name="vgg8", input_size=16)),
            override=True)
        m1, _ = registry.compile_entry("vgg8-rereg-test")
        store1 = registry.scenario_store("vgg8-rereg-test", device="cpu")
        store1.register("s", branch=scenario.split_params(
            m1.init(0, device="cpu"))[0])
        registry.register(registry.ModelEntry(
            "vgg8-rereg-test",
            config=lambda: cnn.CNNConfig(name="vgg8", input_size=32)),
            override=True)
        assert not registry.has_scenarios("vgg8-rereg-test")
        m2, _ = registry.compile_entry("vgg8-rereg-test")
        assert m2.cfg.input_size == 32 and m2 is not m1
        store2 = registry.scenario_store("vgg8-rereg-test", device="cpu")
        assert store2 is not store1 and "s" not in store2
        assert store2.model is m2

    def test_compile_racing_reregister_never_publishes_stale_cell(self):
        def old_factory():
            registry.register(registry.ModelEntry(
                "race-test",
                config=lambda: cnn.CNNConfig(name="vgg8", input_size=32)),
                override=True)
            return cnn.CNNConfig(name="vgg8", input_size=16)

        registry.register(registry.ModelEntry("race-test",
                                              config=old_factory),
                          override=True)
        model, _ = registry.compile_entry("race-test")
        assert model.cfg.input_size == 32    # stale 16 px cell discarded


class TestRegistryLRU:
    def _mini(self, name, size=16):
        registry.register(registry.ModelEntry(
            name, config=lambda: cnn.CNNConfig(name="vgg8",
                                               input_size=size)),
            override=True)

    def test_cap_evicts_oldest_and_hits_refresh_recency(self):
        for n in ("lru-a", "lru-b", "lru-c"):
            self._mini(n)
        try:
            registry.set_max_resident(2)
            assert registry.max_resident() == 2
            ma, _ = registry.compile_entry("lru-a")
            registry.compile_entry("lru-b")
            registry.compile_entry("lru-a")   # hit: a becomes most recent
            registry.compile_entry("lru-c")   # evicts b, NOT a
            ids = registry.resident_ids()
            assert "lru-b" not in ids and ids[-2:] == ["lru-a", "lru-c"]
            assert len(ids) <= 2
            assert registry.compile_entry("lru-a")[0] is ma
        finally:
            registry.set_max_resident(None)
            for n in ("lru-a", "lru-b", "lru-c"):
                registry.evict(n)

    def test_evict_drops_cell_and_store(self):
        self._mini("lru-d")
        m1, _ = registry.compile_entry("lru-d")
        registry.scenario_store("lru-d", device="cpu")
        assert registry.evict("lru-d")
        assert not registry.evict("lru-d")    # idempotent
        assert not registry.has_scenarios("lru-d")
        assert registry.compile_entry("lru-d")[0] is not m1
        registry.evict("lru-d")

    def test_cap_validation(self):
        with pytest.raises(ValueError, match="max_resident"):
            registry.set_max_resident(0)
        assert registry.max_resident() is None
