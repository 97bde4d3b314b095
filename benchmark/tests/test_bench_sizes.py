"""`small_bench` sizes a traffic file by its keys, whatever its driver: a
traffic added with a driver of its own is sized too, and raises nothing."""

import json
import os
import shutil

from conftest import BENCH, FRAME, TRAIN, small_copy


def test_a_traffic_of_an_unknown_driver_is_sized(tmp_path):
    src = tmp_path / "src"
    shutil.copytree(BENCH, src, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    (src / "traffic" / "frames_ref_512sq_8spp.json").write_text(json.dumps(
        {"driver": "frame_ref", "width": 512, "height": 512, "spp": 8, "why": "a driver no test knows"}
    ))
    bd = small_copy(tmp_path / "run", src=str(src))
    sized = {}
    for name in os.listdir(os.path.join(bd, "traffic")):
        with open(os.path.join(bd, "traffic", name)) as f:
            d = json.load(f)
        sized[name] = {k: d[k] for k in FRAME}
    assert sized["frames_ref_512sq_8spp.json"] == FRAME
    assert sized["frames_1024sq_16spp.json"] == FRAME
    assert sized["train_adam_512sq_8spp.json"] == TRAIN
