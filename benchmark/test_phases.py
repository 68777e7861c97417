"""CPU tests of `phases.py` on synthetic profiler events: the program's
`leco.` ranges split the traced pair's device time, launches and idle
gaps by phase, the phases and "outside the step" add up to the pair's
device time, each gap goes to the phase of the launch that ends it, and
`per_layer` reads the result (and stays silent where nothing was counted).

    python -m pytest benchmark/ -q
"""

from __future__ import annotations

import pytest

import harness
import phases
import tracing


class Event:
    """The part of a profiler event that `tracing` and `phases` read."""

    def __init__(self, name, device, start, dur, corr=0, link=0, annotation=False):
        self._v = (name, device, start, dur, corr, link, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v[1] == "cuda" else DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def span(name, start, end, corr):
    return Event(name, "cpu", start, end - start, corr, annotation=True)


def launch(op, start, corr, runtime_corr):
    """An operator and its runtime launch call, 10 ns in."""
    return [Event(op, "cpu", start, 20, corr),
            Event("cudaLaunchKernel", "cpu", start + 10, 5, runtime_corr, corr)]


def kernel(name, start, dur, runtime_corr, op_corr):
    return Event(name, "cuda", start, dur, runtime_corr, op_corr)


# one step: leco.step [0, 9200] holds fold [100, 1000], inner_denoise
# [1000, 5000], backward [6000, 8000] and optimizer [8000, 9000]; a kernel
# launched in each, one in the step's glue (5500) and one outside (9500)
CPU = [span("leco.step", 0, 9200, 1), span("leco.fold", 100, 1000, 2),
       span("leco.inner_denoise", 1000, 5000, 3), span("leco.backward", 6000, 8000, 4),
       span("leco.optimizer", 8000, 9000, 5),
       span("bench/unet/other", 1100, 4900, 6),
       *launch("aten::mm", 200, 10, 100), *launch("aten::add", 1200, 11, 101),
       *launch("aten::add", 1300, 12, 102), *launch("aten::mul", 5500, 13, 103),
       *launch("aten::mm", 6500, 14, 104), *launch("aten::_foreach_mul_", 8200, 15, 105),
       *launch("aten::_local_scalar_dense", 9500, 16, 106)]
# device: busy [300, 800], [1500, 2000] and [2000, 2600], [5600, 5700],
# [7000, 7800], [8500, 8600], [9600, 9650]
DEVICE = [kernel("sm80_xmma_gemm_f32f32", 300, 500, 100, 10),
          kernel("vectorized_elementwise_kernel", 1500, 500, 101, 11),
          kernel("vectorized_elementwise_kernel", 2000, 600, 102, 12),
          kernel("elementwise_kernel", 5600, 100, 103, 13),
          kernel("nvjet_tst_gemm", 7000, 800, 104, 14),
          kernel("multi_tensor_apply_kernel", 8500, 100, 105, 15),
          kernel("Memcpy DtoH", 9600, 50, 106, 16)]
SESSION = {"device": DEVICE, "cpu": CPU, "wall_s": 10e-6}
RECORDED = {"spans": [{"name": n, "start_ns": s, "end_ns": e, "parent": p} for n, s, e, p in (
    ("leco.step", 0, 9200, None), ("leco.fold", 100, 1000, 0),
    ("leco.inner_denoise", 1000, 5000, 0), ("leco.backward", 6000, 8000, 0),
    ("leco.optimizer", 8000, 9000, 0))], "counters": {"unet.inner_calls": 2}}


def test_phases_split_the_pairs_device_time():
    p = phases.read(SESSION, RECORDED)
    ms = 1e-6
    assert p["by_phase_ms"] == pytest.approx({
        "fold": 500 * ms, "inner_denoise": 1100 * ms, "backward": 800 * ms,
        "optimizer": 100 * ms, "step": 100 * ms, "outside the step": 50 * ms})
    assert list(p["by_phase_ms"]) == ["fold", "inner_denoise", "backward", "optimizer", "step",
                                      "outside the step"]
    assert p["launches_by_phase"] == {"fold": 1, "inner_denoise": 2, "backward": 1,
                                      "optimizer": 1, "step": 1, "outside the step": 1}
    total = sum(e.duration_ns() for e in DEVICE) * ms
    assert sum(p["by_phase_ms"].values()) == pytest.approx(total) == p["device_ms"]
    assert sum(tracing.analyze(SESSION, 1)["by_category_ms"].values()) == pytest.approx(total)
    assert p["inner_calls"] == 2 and p["steps"] == 1
    assert p["clock_offset_us"] == 0 and p["annotations_counted"] == 0


def test_each_gap_goes_to_the_phase_of_the_launch_that_ends_it():
    idle = phases.read(SESSION, RECORDED)["idle_by_phase_ms"]
    ms = 1e-6
    # gaps: 800-1500 (ended by the inner denoise), 2600-5600 (the step's
    # glue), 5700-7000 (backward), 7800-8500 (optimizer), 8600-9600 (outside)
    assert idle == pytest.approx({"inner_denoise": 700 * ms, "step": 3000 * ms,
                                  "backward": 1300 * ms, "optimizer": 700 * ms,
                                  "outside the step": 1000 * ms})
    busy_ns, gaps = tracing._union(sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                                          for e in DEVICE))
    assert sum(idle.values()) == pytest.approx(sum(b - a for a, b in gaps) * ms)


def test_counters_cover_only_the_kept_session():
    """profile_pair may take its session again: the recorder then holds the
    spans and counts of every attempt, the CPU events only the last's."""
    twice = {"spans": RECORDED["spans"] * 2, "counters": {"unet.inner_calls": 4}}
    p = phases.read(SESSION, twice)
    assert p["inner_calls"] == 2 and p["clock_offset_us"] == 0


def test_the_recorders_stamps_are_held_to_the_profilers():
    shifted = {"spans": [dict(s, start_ns=s["start_ns"] + 1500) for s in RECORDED["spans"]],
               "counters": {}}
    assert phases.read(SESSION, shifted)["clock_offset_us"] == pytest.approx(1.5)
    renamed = {"spans": RECORDED["spans"][:-1], "counters": {}}
    assert phases.read(SESSION, renamed)["clock_offset_us"] is None


def test_without_program_ranges_nothing_is_read():
    cpu = [e for e in CPU if not e.name().startswith("leco.")]
    assert phases.read({"device": DEVICE, "cpu": cpu, "wall_s": 1e-5},
                       {"spans": [], "counters": {}}) is None


def test_program_ranges_leave_the_existing_numbers_as_they_were():
    """tracing.analyze ignores the `leco.` ranges (its scopes are `bench/`),
    and profile_pair's filter drops them as device records too."""
    cpu = [e for e in CPU if not e.name().startswith("leco.")]
    with_ranges = tracing.analyze(SESSION, 1)
    without = tracing.analyze({"device": DEVICE, "cpu": cpu, "wall_s": 10e-6}, 1)
    assert with_ranges == without
    assert tracing._annotation(Event("leco.step", "cuda", 0, 10000, annotation=True))
    assert tracing._annotation(Event("leco.backward", "cuda", 0, 10, annotation=True))


def test_setup_reads_the_library_spans_and_nvcc_runs():
    taken = {"spans": [{"name": "leco.step", "start_ns": 0, "end_ns": 5, "parent": None},
                       {"name": "leco.kernels.library", "start_ns": 1, "end_ns": 2_500_000_001,
                        "parent": 0}],
             "counters": {"kernels.nvcc_runs": 1, "unet.inner_calls": 3}}
    s = phases.setup(taken)
    assert s["kernel_library_s"] == pytest.approx(2.5) and s["nvcc_runs"] == 1
    assert phases.setup({"spans": [], "counters": {}})["kernel_library_s"] is None


def test_per_layer_reads_the_phases():
    p = phases.read(SESSION, RECORDED)
    setup = phases.setup({"spans": [{"name": "leco.kernels.library", "start_ns": 0,
                                     "end_ns": 40_000_000, "parent": None}], "counters": {}})
    want = {"train.fold_ms_per_it": 250e-6, "train.backward_ms_per_it": 400e-6,
            "train.optimizer_ms_per_it": 50e-6,
            "train.inner_denoise_idle_share": 100 * 700 / (1100 + 700),
            "train.inner_launches_per_forward": 1.0, "setup.kernel_library_s": 0.04}
    assert phases.per_layer(p, 2, setup) == pytest.approx(want)


def test_per_layer_is_silent_where_nothing_was_counted():
    """No inner denoise in the pair, no counter, no library span."""
    cpu = [e for e in CPU if e.name() != "leco.inner_denoise"]
    p = phases.read({"device": DEVICE, "cpu": cpu, "wall_s": 1e-5},
                    {"spans": [], "counters": {}})
    read = phases.per_layer(p, 2, phases.setup({"spans": [], "counters": {}}))
    assert read["train.inner_denoise_idle_share"] is None
    assert read["train.inner_launches_per_forward"] is None
    assert read["setup.kernel_library_s"] is None
    assert read["train.fold_ms_per_it"] == pytest.approx(250e-6)


def test_phase_table_takes_the_cell_as_the_harness_does(monkeypatch, capsys):
    import phase_table

    cell = phase_table.cell_of("sd15-erase-b2", 2**31 + 7, 5, 0.0)
    bench = harness.manifest()
    w = next(w for w in bench["workloads"] if w["name"] == "sd15-erase-b2")
    assert cell.trace and cell.seed == 2**31 + 7 and cell.chips == w["chips"]
    assert cell.traffic["runner"] == "lora_train" and "unet" in cell.config
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert phase_table.main(["--workload", "sd15-erase-b2", "--seed", "1"], 0.0) == 3
    assert "CUDA" in capsys.readouterr().err


def test_recorder_is_the_programs():
    from leco_tpu_torch.utils import profiling

    assert phases.recorder() is profiling
