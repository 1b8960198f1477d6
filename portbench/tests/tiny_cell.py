"""A copy of the benchmark at a size the CPU holds: the harness's files as
they are, with tiny configurations (2 blocks of 2 x 32 heads, a 64-channel
upsampler and decoder), a tiny distilled traffic (2 videos of 128 x 128 x 9,
2 + 1 steps; a dev traffic of 2-step slices of a 4-step schedule, with
a 16-channel encoder; LoRA training on three 48-token clips) and four
cells over them. Limits set from the CPU's own readings of these sizes
(program against reference: latents 5.3e-3 to 6.4e-3, frames 1.6e-2 to
1.9e-2, encoded image 0, a slice 4.0e-3 to 4.1e-3, losses 6e-5 to 2.6e-4,
first gradients 2.5e-3 to 3.5e-3, changes 2.5e-3 to 3.1e-3; the float8
control: 4.6e-2 to 5.0e-2, 0.132 to 0.148, 7.1e-2 to 7.9e-2, 3.3e-2 to
3.6e-2, 7.6e-4 to 1.3e-3, 3.6e-2 to 5.1e-2, 1.1e-2 to 1.3e-2)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

PB = Path(__file__).resolve().parent.parent
REPO = PB.parent
CELLS = ("tiny", "tinyq", "tinydev", "tinylora")
CONFIG = {"tiny": "tiny", "tinyq": "tinyq", "tinydev": "tiny", "tinylora": "tiny"}
TRAFFIC = {"tiny": "tiny", "tinyq": "tiny", "tinydev": "tinydev", "tinylora": "tinylora"}
DISTILLED = {"latent_rel_l2": 0.02, "video_rel_l2": 0.07}
LIMITS = {"tiny": DISTILLED, "tinyq": DISTILLED, "tinydev": {"encode_rel_l2": 0.02, "slice_rel_l2": 0.015},
          "tinylora": {"loss_rel": 4e-4, "grad1_rel": 0.015, "change3_rel": 7e-3}}


def tiny_config(quant: bool = False) -> dict:
    cfg = json.loads((PB / "configs" / "ltx2-19b-video-bf16.json").read_text())
    cfg.update(name="tinyq" if quant else "tiny", num_layers=2, num_attention_heads=2, attention_head_dim=32,
               in_channels=16, out_channels=16, cross_attention_dim=64, caption_channels=48, caption_positions=16,
               upsampler={"in_channels": 16, "mid_channels": 64, "num_blocks": 1})
    cfg["decoder"] = dict(cfg["decoder"], in_channels=16, base_channels=64, num_layers_per_block=1)
    cfg["encoder"] = {"in_channels": 3, "out_channels": 16, "patch_size": 4, "blocks": [
        ["res_x", {"num_layers": 1}], ["compress_space_res", {"multiplier": 1}],
        ["compress_time_res", {"multiplier": 1}], ["compress_all_res", {"multiplier": 1}],
        ["compress_all_res", {"multiplier": 1}], ["res_x", {"num_layers": 1}]]}
    if quant:
        cfg["quant"] = {"bits": 4, "group_size": 32, "scope": "core", "scale_dtype": "bfloat16"}
    return cfg


def tiny_traffic() -> dict:
    t = json.loads((PB / "traffic" / "distilled-512x33-x4.json").read_text())
    t.update(height=128, width=128, num_frames=9, stage1_steps=2, stage2_steps=1, num_videos=2, check_calls=1,
             trace_calls=1)
    return t


def tiny_dev_traffic() -> dict:
    t = json.loads((PB / "traffic" / "dev-768x65-cfg.json").read_text())
    t.update(height=128, width=128, num_frames=9, steps=4, slice_steps=2, check_calls=1, trace_calls=1,
             calibrate_calls=2)
    return t


def tiny_lora_traffic() -> dict:
    t = json.loads((PB / "traffic" / "lora-768x512x65.json").read_text())
    t.update(clips=3, latent_shape=[16, 2, 4, 6], caption_positions=16, caption_real=8, trace_steps=2)
    return t


def write(path: Path, obj: dict) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def make_root(tmp: Path) -> Path:
    """A checkout-like root under ``tmp``: BENCHMARK.json and portbench/,
    with the tiny files added and the cells renamed; the metric entries are
    the repository's and ``pending_cells.json``'s (the dev and LoRA cells'
    entries, built and tested here but not yet in BENCHMARK.json), their
    cells mapped to the tiny ones."""
    root = Path(tmp) / "root"
    shutil.copytree(PB, root / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for cfg in (tiny_config(), tiny_config(True)):
        write(root / "portbench" / "configs" / f"{cfg['name']}.json", cfg)
    write(root / "portbench" / "traffic" / "tiny.json", tiny_traffic())
    write(root / "portbench" / "traffic" / "tinydev.json", tiny_dev_traffic())
    write(root / "portbench" / "traffic" / "tinylora.json", tiny_lora_traffic())
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pending = json.loads((Path(__file__).resolve().parent / "pending_cells.json").read_text())
    for key, entries in pending.items():  # the cells built but not yet proven on the card
        bench[key] += entries
    names = {"distilled-512x33-x4": "tiny", "q4-distilled-512x33-x4": "tinyq", "dev-768x65-cfg": "tinydev",
             "lora-768x512x65": "tinylora"}
    cells = {c["name"]: c for c in bench["workloads"]}
    bench["workloads"] = [dict(cells[old], name=new, config=CONFIG[new], traffic=TRAFFIC[new])
                          for old, new in names.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [names[c] for c in m["workloads"] if c in names]
    write(root / "BENCHMARK.json", bench)
    for cell in CELLS:
        write(root / "portbench" / "limits" / f"{cell}.json", {"limits": LIMITS[cell]})
    return root
