"""``CPUGraph``: a CPU stand-in for ``torch.cuda.CUDAGraph``, set through
``repro_torch.serving.programs._graph_double`` by the program-cache tests
(``test_torch_programs.py``, ``test_torch_train_programs.py``).

A "capture" runs the function once over the static buffers and puts back
every state tensor it wrote (a capture launches nothing and changes no
state); a "replay" runs it again into the same output tensors.
"""
import torch

from repro_torch.kernels import build


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif dst is not None:
        for d, s in zip(dst, src):
            _copy_into(d, s)


class CPUGraph:
    """A CPU stand-in for ``torch.cuda.CUDAGraph`` (see the module docstring)."""

    def capture(self, run, state):
        saved = [s.clone() for s in state]
        self.run, self.out = run, run()
        for s, v in zip(state, saved):
            s.copy_(v)
        return self.out

    def replay(self):
        # a card's replay runs no Python: the wrappers' own counts are undone,
        # so only what the program recorded at capture is added
        counts = {c: c.launches for c in build.COUNTERS}
        _copy_into(self.out, self.run())
        for c, n in counts.items():
            c.launches = n
