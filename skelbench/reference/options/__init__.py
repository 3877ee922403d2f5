"""One module a skeletonize option that the reference does not implement
itself (`judge.BUILT_IN`), named as the option: `prepare(labels, graph,
value)` returns the labels (a host integer array) and the voxel graph (a
host uint32 array or None) that the reference reads under the option."""
