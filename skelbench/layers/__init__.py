"""One module a per-layer metric, named as the metric: `read(record)`
returns its value from the traced run's record, or None where the run has
nothing to read it from. The record (built by `run.py`):

- `chunks`: chunks the window completed;
- `phases`, `counters`: the program's phase seconds and counters summed
  over the window (`kimimaro_tpu_torch.utils.profiling`);
- `launches`: the program's kernel launches over the window;
- `profile`: the one chunk run under `torch.profiler` after the window:
  `window_s` its length, `busy_s` the union of the card's operation
  intervals, `device_s` {operation name: device seconds}, `calls`
  {"b2": [bytes of each call], "b4": [...]} from `spy.KernelSpy`,
  `launches` the program's kernel launches in that chunk.
"""
