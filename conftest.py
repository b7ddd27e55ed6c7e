"""Hand the test files to pytest-xdist's workers longest first.

Under ``--dist loadfile`` xdist hands out whole files, in the order of their
test count, most first. A long file then starts only after every file with
more tests has been handed out, and the run lasts that delay plus the file.
This hook hands out the work by its measured seconds instead, from
``FILE_SECONDS`` (kept here: the test command runs with ``-p
no:cacheprovider``, so there is no cache to learn them from). Two files are
longer than a worker's share of the whole run (``SPLIT_UNITS``): they are
handed out in smaller units, tests that reuse what another compiled in the
worker's process kept together in one. Their units' seconds are in
``UNIT_SECONDS``. Work
that is not in either table goes after everything that is, by test count.
A worker that already holds more than its share of the run's seconds gets
the shortest unit left instead of the next longest. Which tests run, and
how, does not change; only how they are grouped and the order in which they
are handed out.

The tables: seconds of test time (setup, call and teardown summed from the
junit report) of runs of ``python -m pytest tests/ -q -m 'not slow' -p
no:cacheprovider -p xdist -n 6 --dist loadfile`` on an 8-core machine.
Refresh them when a file's time moves by much. At the end of a run under
xdist each worker's sum of test seconds is printed.
"""

import pytest

FILE_SECONDS = {
    "tests/test_model_zoo.py": 646, "tests/test_kernels.py": 266,
    "tests/test_graph.py": 265, "tests/test_llama.py": 265,
    "tests/test_export.py": 232, "tests/test_finn_export.py": 221,
    "tests/test_checkpoint_examples.py": 215, "tests/test_autograph.py": 213,
    "tests/test_rnn.py": 206, "tests/test_end_to_end.py": 161,
    "tests/test_int4_kv.py": 144, "tests/test_torch_port_mobilenet.py": 144,
    "tests/test_export_matrix.py": 133,
    "tests/test_export_derive.py": 122, "tests/test_vit.py": 111,
    "tests/test_properties.py": 105, "tests/test_compute_dtype.py": 104,
    "tests/test_audio.py": 85, "tests/test_parallel.py": 72,
    "tests/test_dynamic_quant.py": 68, "tests/test_pipeline.py": 65,
    "tests/test_torch_port_attention.py": 59, "tests/test_torch_port_cnv.py": 55,
    "tests/test_torch_port_quartznet.py": 52,
    "tests/test_moe.py": 55,
    "tests/test_gpfq.py": 55, "tests/test_torch_port_w4a8.py": 54,
    "tests/test_mixed_precision.py": 54, "tests/test_quantizers.py": 52,
    "tests/test_float_quant.py": 49, "tests/test_nn_layers.py": 49,
    "tests/test_gptq.py": 48, "tests/test_torch_export.py": 43,
    "tests/test_learned_round.py": 43, "tests/test_awq.py": 38,
    "tests/test_torch_import.py": 35, "tests/test_torch_port_transformer.py": 30,
    "tests/test_torch_port_kernels.py": 30, "tests/test_groupwise.py": 26,
    "tests/test_core_quant.py": 24, "tests/test_torch_port_lstm.py": 22,
    "tests/test_rotate.py": 21, "tests/test_torch_port_llama.py": 20,
    "tests/test_a2q.py": 19, "tests/test_onnx_validate.py": 18,
    "tests/test_torch_port_lfc_qat.py": 16, "tests/test_vision.py": 14,
    "tests/test_torch_port_bnn.py": 38, "tests/test_torch_port_quant_options.py": 20,
    "tests/test_torch_port_serving.py": 14, "tests/test_torch_port_quant.py": 10,
    "tests/test_torch_port_fake_quant.py": 9, "tests/test_torch_port_llm_ptq.py": 57,
    "tests/test_torch_port_llm_ptq_flags.py": 51,
    "tests/test_torch_port_ptq.py": 66, "tests/test_torch_port_ptq_cli.py": 95,
    "tests/test_torch_port_export.py": 68, "tests/test_torch_port_export_derive.py": 24,
    "tests/test_profiling.py": 10, "tests/test_quant_tensor.py": 6,
    "tests/test_native_ste.py": 4, "tests/test_ops_ste.py": 4,
    "tests/test_hygiene.py": 1, "tests/test_reference_parity.py": 1,
    "tests/test_multihost.py": 1, "tests/test_bench_headline.py": 1,
    "tests/test_data_loader.py": 1,
}

# The files handed out in units: a test (by name) or a parameter (as
# "[param]") names its unit; every other test of the file is in the unit
# "rest". Tests that reuse each other's compiles share a unit: the zoo's
# two tests of an architecture (the export after the end-to-end test took
# 55 s, alone 325 s), its two ResNet backbones, and test_models.py's
# MobileNet-family tests (151 s together, 280 s apart).
SPLIT_UNITS = {
    "tests/test_models.py": {
        "test_transformer_decode_matches_full_forward": "transformer_decode",
        "test_transformer_int8_decode_matches_full_forward": "transformer_int8_decode",
        "test_transformer_generate_greedy": "transformer_generate",
    },
    "tests/test_torchvision_zoo.py": {
        "[googlenet]": "googlenet", "[mnasnet0_5]": "mnasnet0_5",
        "[mobilenet_v2]": "mobilenet_v2", "[fcn_resnet]": "resnet",
        "[deeplabv3_resnet]": "resnet", "[regnet_x_400mf]": "regnet_x_400mf",
        "[squeezenet1_0]": "squeezenet1_0", "[alexnet]": "alexnet",
        "[densenet]": "densenet",
        "test_densenet_standalone_bns_become_quant_scale_bias": "densenet",
    },
}

# the sums of each unit's tests when every test ran on its own
UNIT_SECONDS = {
    "tests/test_models.py::transformer_int8_decode": 296,
    "tests/test_models.py::transformer_generate": 293,
    "tests/test_models.py::transformer_decode": 291,
    "tests/test_models.py::rest": 280,
    "tests/test_torchvision_zoo.py::googlenet": 358,
    "tests/test_torchvision_zoo.py::mnasnet0_5": 296,
    "tests/test_torchvision_zoo.py::resnet": 254,
    "tests/test_torchvision_zoo.py::mobilenet_v2": 215,
    "tests/test_torchvision_zoo.py::regnet_x_400mf": 133,
    "tests/test_torchvision_zoo.py::squeezenet1_0": 128,
    "tests/test_torchvision_zoo.py::densenet": 104,
    "tests/test_torchvision_zoo.py::alexnet": 96,
    "tests/test_torchvision_zoo.py::rest": 26,
}


def split_scope(nodeid: str) -> str:
    """The unit of work a test belongs to: its file, or, in a file of
    ``SPLIT_UNITS``, ``file::unit``."""
    path, _, name = nodeid.partition("::")
    units = SPLIT_UNITS.get(path)
    if units is None:
        return path
    param = name[name.index("["):] if name.endswith("]") else None
    return f"{path}::{units.get(param, units.get(name, 'rest'))}"


def unit_seconds(unit: str):
    """A unit's measured seconds, or None where neither table has it."""
    return UNIT_SECONDS.get(unit, FILE_SECONDS.get(unit))


def _longest_first(base):
    class LongestFirst(base):
        """``LoadFileScheduling`` with ``split_scope``'s units, whose queue is
        sorted by their seconds before the first unit is handed out. A
        worker that already holds more than its share of the run's seconds
        gets the shortest unit left, so that nothing long queues behind the
        longest units."""

        _share = None

        def _split_scope(self, nodeid: str) -> str:
            return split_scope(nodeid)

        def _assign_work_unit(self, node) -> None:
            if self._share is None:
                units = sorted(self.workqueue.items(), key=lambda unit: (
                    unit_seconds(unit[0]) is None, -(unit_seconds(unit[0]) or 0.0),
                    -len(unit[1])))
                self.workqueue.clear()
                self.workqueue.update(units)
                self._share = sum(unit_seconds(u) or 0.0 for u in self.workqueue) \
                    / max(len(self.nodes), 1)
            held = sum(unit_seconds(u) or 0.0 for u in self.assigned_work.get(node, {}))
            if held > self._share:
                self.workqueue.move_to_end(next(reversed(self.workqueue)), last=False)
            super()._assign_work_unit(node)

    return LongestFirst


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    return _longest_first(LoadFileScheduling)(config, log)


class WorkerSeconds:
    """Sums each xdist worker's test seconds on the controller (which
    receives every worker's reports) and prints them at the end."""

    def __init__(self):
        self.seconds = {}

    def pytest_runtest_logreport(self, report) -> None:
        node = getattr(report, "node", None)
        if node is not None:
            worker = node.gateway.id
            self.seconds[worker] = self.seconds.get(worker, 0.0) + report.duration

    def pytest_terminal_summary(self, terminalreporter) -> None:
        if self.seconds:
            terminalreporter.write_line("test seconds by worker: " + ", ".join(
                f"{w} {s:.1f}" for w, s in sorted(self.seconds.items())))


def pytest_configure(config) -> None:
    config.pluginmanager.register(WorkerSeconds(), "worker-seconds")
