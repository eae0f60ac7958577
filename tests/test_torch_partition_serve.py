"""The partitioner on real process groups (4 gloo ranks on the CPU, at
float32), continued from ``tests/test_torch_partition_group.py``, whose
rank prelude it shares:

* **The seq_model path**: a reduced config of 6 query heads on 1 x 4 (the
  model axis does not divide them): q sharded on the sequence, K7 (its
  plain version) on rank r at query offset 16 r; the loss and every
  gradient within 1e-6 / 1e-5 of the unsharded port (float32 sums of
  another order), and a left-padded prefill's greedy tokens equal.
* **Serving**: ``ServeEngine(partitioner=)`` on 2 x 2 (prefill and
  decode), chip_smoke.py's phase-10 weights and prompts: the reference's
  greedy tokens (the first SERVE_NEW of ``LM_REDUCED_EXPECTED``).
* **Elastic restore**: saved on 4 x 1, restored onto 1 x 4 — a leaf placed
  ("batch", "vocab") and a whole train state (FSDP): bit-equal, with the
  placements asked for, into the target's own tensors.
"""

from __future__ import annotations

import pytest

from test_torch_collectives import run_ranks
from test_torch_partition_group import PRELUDE, SERVE_ARCHS, SERVE_NEW, cs, write_config

BODY = PRELUDE + """
# the seq_model path: 6 query heads on 1 x 4
seq_cfg = dataclasses.replace(get_config("gemma2-9b").reduced(), n_heads=6, n_kv_heads=2)
offsets = []
plain_bw = fa.blockwise_attention
def recording(q, k, v, **kw):
    offsets.append(kw.get("q_off", 0))
    return plain_bw(q, k, v, **kw)
attn_mod.fa.blockwise_attention = recording
part = Partitioner(meshes["1x4"])
weights = params_from_jax(numpy_params(seq_cfg, cfg_in["seed"]), seq_cfg)
_, batch = next(make_batch_iterator(seq_cfg, ShapeConfig("r", "train", 64, 2), seed=3))
grads = {}
for sharded in (False, True):
    model = Decoder(seq_cfg, device="cpu", seed=None)
    model.load_state_dict(weights)
    shard = None
    if sharded:
        tstep.shard_model(model, part)
        shard = part
    loss_fn = tstep.make_loss_fn(model, shard)
    params = model.trainable()
    with replicate_plain():
        loss, _ = loss_fn(params, batch)
        if shard is not None:
            from repro_torch.dist.partition import replicate_plain_in_backward
            replicate_plain_in_backward(loss)
        g = torch.autograd.grad(loss, list(params.values()))
        g = [x.full_tensor() if isinstance(x, DTensor) else x for x in g]
        loss = loss.full_tensor() if isinstance(loss, DTensor) else loss
    grads[sharded] = (float(loss), g)
out["seq_loss"] = [grads[False][0], grads[True][0]]
out["seq_grad_err"] = max(float((a - b).abs().max() / (b.abs().max() + 1e-30))
                          for a, b in zip(grads[True][1], grads[False][1]))
out["seq_offsets"] = sorted(set(offsets))
rng = np.random.default_rng(5)
prompts = [rng.integers(0, seq_cfg.vocab_size, size=n).tolist() for n in (12, 16, 3, 9)]
tokens = []
for sharded in (False, True):
    model = Decoder(seq_cfg, device="cpu", seed=None)
    model.load_state_dict(weights)
    eng = ServeEngine(seq_cfg, model, ServeConfig(max_len=64, batch_slots=4), device="cpu",
                      partitioner=part if sharded else None)
    offsets.clear()
    tokens.append(eng.generate(prompts, 6))
out["seq_serve_equal"] = tokens[0] == tokens[1]
out["seq_serve_offsets"] = sorted(set(offsets))
attn_mod.fa.blockwise_attention = plain_bw
lap("seq")

# serving on 2 x 2 against the reference's greedy tokens
part = Partitioner(meshes["2x2"])
for arch in cfg_in["serve"]:
    cfg = get_config(arch).reduced()
    model = Decoder(cfg, device="cpu", seed=None)
    model.load_state_dict(params_from_jax(numpy_params(cfg, cfg_in["seed"]), cfg))
    prompts = cfg_in["prompts"][arch]
    eng = ServeEngine(cfg, model, ServeConfig(max_len=cfg_in["max_len"],
                                              batch_slots=max(4, len(prompts))),
                      device="cpu", partitioner=part)
    out["serve_" + arch] = eng.generate(prompts, cfg_in["max_new"])
    out["serve_placed_" + arch] = isinstance(model.embed, DTensor)
lap("serve")

# elastic restore: 4 x 1 -> 1 x 4
p41, p14 = Partitioner(meshes["4x1"]), Partitioner(meshes["1x4"])
x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
tree = {"w": distribute(x, p41.sharding(("batch", "vocab"), x.shape))}
save_checkpoint("elastic", 1, tree)
sh = {"w": p14.sharding(("batch", "vocab"), x.shape)}
back = restore_checkpoint("elastic", 1, tree, shardings=sh)
out["elastic_leaf"] = {"equal": bool(torch.equal(back["w"].full_tensor(), x)),
                       "saved": pl(tree["w"].placements),
                       "placements": pl(back["w"].placements), "want": pl(sh["w"].placements)}
losses, model, state, sh41 = train(get_config("gemma2-9b").reduced(), "gemma2-9b", "4x1", 1)
from repro_torch.checkpoint import flatten
saved = {k: v.full_tensor() for k, v in flatten(state).items()}
save_checkpoint("elastic", 2, state)
model14 = Decoder(get_config("gemma2-9b").reduced(), device="cpu", seed=7)
opt = get_optimizer("adamw", warmup_cosine(1e-3, 1, 3))
sh14 = tstep.model_state_shardings(Partitioner(meshes["1x4"], fsdp=True), model14, opt)
tstep.shard_model(model14, Partitioner(meshes["1x4"], fsdp=True))
fresh = tstep.init_state(model14, opt, sh14)
back = restore_checkpoint("elastic", 2, fresh, shardings=sh14)
flat, flat_sh = flatten(back), {}
from repro_torch.checkpoint.ckpt import flatten_shardings
flat_sh = flatten_shardings(sh14)
out["elastic_state"] = {
    "equal": all(torch.equal(flat[k].full_tensor(), saved[k]) for k in saved),
    "placed": all(tuple(flat[k].placements) == tuple(flat_sh[k].placements) for k in flat),
    "in_place": back["params"]["embed"] is model14.embed,
    "moved": any(tuple(sh41["params"][k].placements) != tuple(sh14["params"][k].placements)
                 for k in sh14["params"]),
    "leaves": len(saved)}
lap("elastic")
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("partition_serve")
    write_config(tmp)
    return run_ranks(tmp, BODY, world=4, timeout=300)


def test_sequence_sharded_attention_path(results):
    for r in results:
        plain, sharded = r["seq_loss"]
        assert abs(plain - sharded) <= 1e-6
        assert r["seq_grad_err"] <= 1e-5
        # rank r holds rows [16 r, 16 r + 16) of the 64 (the unsharded run: 0),
        # and of the 16-token prefill [4 r, 4 r + 4)
        assert r["seq_offsets"] == sorted({0, 16 * r["rank"]})
        assert r["seq_serve_offsets"] == [4 * r["rank"]] and r["seq_serve_equal"]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_partitioned_serving_gives_the_references_tokens(results, arch):
    for r in results:
        assert r["serve_placed_" + arch]
        assert r["serve_" + arch] == [t[:SERVE_NEW] for t in cs.LM_REDUCED_EXPECTED[arch]]


def test_elastic_restore_onto_another_mesh(results):
    for r in results:
        leaf = r["elastic_leaf"]
        assert leaf["equal"] and leaf["saved"] == ["S0", "R"]
        assert leaf["placements"] == leaf["want"] == ["R", "S1"]
        st = r["elastic_state"]
        assert st["equal"] and st["placed"] and st["in_place"] and st["moved"]
        assert st["leaves"] > 0
