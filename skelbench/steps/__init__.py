"""One module a traffic step, named as the step: `apply(vol, graph, params,
shape, device)` returns (labels, voxel graph or None) after the step.
`vol` is the labels the earlier steps made (None for the first step), an
int32 tensor on `device`; `graph` a host uint32 array or None; `params`
the step's entry in the traffic file; `shape` the config's chunk. A step
draws what it draws from the seeds in `params` alone.
"""
