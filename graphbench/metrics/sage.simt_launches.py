"""``fused_sage_matmul`` launches a window of the CUDA-core ("simt")
kernel, from the program's counter ``ops/sage_kernels.LAUNCHES_BY_VARIANT``
read by the job before and after each window. 0 where every layer takes the
tensor cores. Moves ``edges_per_s``."""

UNIT = "launches/window"


def read(t):
    launches = t["sizes"].get("launches")
    if launches is None or not t["windows"]:
        return None
    return launches["simt"] / t["windows"]
