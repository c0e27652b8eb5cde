"""attn_roofline.stage1: the attention calls' least time at the roofline
(the frozen sum over a step's calls of 512 keys or more of max(operations /
bf16 peak, bytes / HBM bytes a second): ``reference/counts/<cell>.json``)
times the steps, over the device time of the attention family in the
traced window, in %."""

FAMILY = ("flash_fwd", "flash_bwd", "fmha", "sdpa")  # the port's and the libraries' kernels


def read(run):
    s, w = run.summary, run.window
    bound = run.counts.get("attention", {}).get("bound_s_per_step")
    if not s or not bound or not w.get("steps"):
        return None
    device_s = sum(t for name, t in s["kernel_s"].items()
                   if any(k in name.lower() for k in FAMILY))
    return 100.0 * bound * w["steps"] / device_s if device_s > 0 else None
