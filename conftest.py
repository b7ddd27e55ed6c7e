"""Hand the test files to pytest-xdist's workers longest first.

Under ``--dist loadfile`` xdist hands out whole files, in the order of their
test count, most first. The longest file (``tests/test_models.py``: 10 tests,
about a thousand seconds on one worker) then starts only after every file
with more tests has been handed out, and the run lasts that delay plus the
file. This hook hands out the files by their measured seconds instead, from
``FILE_SECONDS`` (kept here: the test command runs with ``-p
no:cacheprovider``, so there is no cache to learn them from). A file that is
not in the table goes after every file that is, by test count. A worker
that already holds more than its share of the run's seconds gets the
shortest file left instead of the next longest. Which tests run, and how,
does not change; only the order in which files are handed out.

The table: seconds of test time per file (setup, call and teardown summed
from the junit report) of one run of ``python -m pytest tests/ -q -m 'not
slow' -p no:cacheprovider -p xdist -n 6 --dist loadfile`` on an 8-core
machine. Refresh it when a file's time moves by much.
"""

import pytest

FILE_SECONDS = {
    "tests/test_torchvision_zoo.py": 994, "tests/test_models.py": 990,
    "tests/test_model_zoo.py": 470, "tests/test_graph.py": 215,
    "tests/test_kernels.py": 191, "tests/test_llama.py": 184,
    "tests/test_finn_export.py": 165, "tests/test_rnn.py": 161,
    "tests/test_export.py": 155, "tests/test_autograph.py": 144,
    "tests/test_checkpoint_examples.py": 113, "tests/test_end_to_end.py": 109,
    "tests/test_export_matrix.py": 76, "tests/test_audio.py": 66,
    "tests/test_vision.py": 63, "tests/test_int4_kv.py": 61,
    "tests/test_compute_dtype.py": 58, "tests/test_vit.py": 49,
    "tests/test_properties.py": 48, "tests/test_export_derive.py": 47,
    "tests/test_torch_export.py": 47, "tests/test_moe.py": 44,
    "tests/test_dynamic_quant.py": 43, "tests/test_pipeline.py": 42,
    "tests/test_nn_layers.py": 39, "tests/test_parallel.py": 37,
    "tests/test_awq.py": 34, "tests/test_gpfq.py": 32,
    "tests/test_torch_port_w4a8.py": 31, "tests/test_float_quant.py": 26,
    "tests/test_quantizers.py": 25, "tests/test_mixed_precision.py": 24,
    "tests/test_torch_port_transformer.py": 23,
    "tests/test_torch_port_attention.py": 30, "tests/test_torch_import.py": 19,
    "tests/test_torch_port_llama.py": 18, "tests/test_learned_round.py": 17,
    "tests/test_torch_port_lstm.py": 16, "tests/test_onnx_validate.py": 14,
    "tests/test_groupwise.py": 14, "tests/test_core_quant.py": 14,
    "tests/test_a2q.py": 12, "tests/test_torch_port_lfc_qat.py": 12,
    "tests/test_torch_port_serving.py": 12, "tests/test_rotate.py": 11,
    "tests/test_torch_port_kernels.py": 14, "tests/test_gptq.py": 9,
    "tests/test_profiling.py": 5, "tests/test_torch_port_quant.py": 4,
    "tests/test_ops_ste.py": 3, "tests/test_quant_tensor.py": 3,
    "tests/test_native_ste.py": 2, "tests/test_data_loader.py": 2,
    "tests/test_hygiene.py": 1,
}


def _longest_file_first(base):
    class LongestFileFirst(base):
        """``LoadFileScheduling`` whose queue of files is sorted by
        ``FILE_SECONDS`` before the first file is handed out. A worker that
        already holds more than its share of the run's seconds gets the
        shortest file left, so that nothing long queues behind the longest
        files."""

        _share = None

        def _assign_work_unit(self, node) -> None:
            if self._share is None:
                units = sorted(self.workqueue.items(), key=lambda unit: (
                    unit[0] not in FILE_SECONDS, -FILE_SECONDS.get(unit[0], 0.0),
                    -len(unit[1])))
                self.workqueue.clear()
                self.workqueue.update(units)
                self._share = sum(FILE_SECONDS.get(f, 0.0) for f in self.workqueue) \
                    / max(len(self.nodes), 1)
            held = sum(FILE_SECONDS.get(f, 0.0) for f in self.assigned_work.get(node, {}))
            if held > self._share:
                self.workqueue.move_to_end(next(reversed(self.workqueue)), last=False)
            super()._assign_work_unit(node)

    return LongestFileFirst


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    return _longest_file_first(LoadFileScheduling)(config, log)
