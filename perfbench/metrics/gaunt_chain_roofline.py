"""gaunt_chain_roofline: the least time of the chain kernel calls in the
traced window (the family's ``kernel_bounds``; MACE:
`perfbench.work.chain_work` on each bucket's rows, at the card's peaks)
over the device time of the kernels named ``gaunt_chain`` there.  Nothing
to read where no chain kernel ran."""


def read(run):
    tr, k = run.get("trace"), (run.get("kernels") or {}).get("gaunt_chain")
    if not tr or not k or not k["launches"]:
        return None
    t = sum(v for name, v in tr["op_s"].items() if "gaunt_chain" in name)
    return 100.0 * k["bound_s"] / t if t > 0 else None
