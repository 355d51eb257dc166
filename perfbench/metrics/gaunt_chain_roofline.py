"""gaunt_chain_roofline: the least time of the chain kernel calls in the
traced window (`perfbench.work.chain_work` on each bucket's rows, at the
card's peaks) over the device time of the kernels named ``gaunt_chain``
there.  Nothing to read where no chain kernel ran."""


def read(run):
    tr, ch = run.get("trace"), run.get("chain")
    if not tr or not ch or not ch["launches"]:
        return None
    t = sum(v for k, v in tr["op_s"].items() if "gaunt_chain" in k)
    return 100.0 * ch["bound_s"] / t if t > 0 else None
