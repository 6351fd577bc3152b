"""The plain reference that decides `correct`: NumPy and plain PyTorch in
float32 (TF32 off), importing neither JAX nor the program.

From the scenes the benchmark generated, it works out again everything the
program derives in its set-up: the voxels and their nearest points
(`voxel`), the level pyramid and every conv's neighbours from dense
occupancy grids (`geometry`), the segment pooling, the U-Net forward, the
losses and Adam (`net`), the box-supervision targets (`targets`) and the
detection-to-mask post-processing (`post`). `numerics` holds the precision
it computes in: the reference's own, and the lower one of the control.
"""
