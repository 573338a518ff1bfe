"""Frame loop: host ms a solve spends before ``fit`` (the frame's upload
and the data term's and the solver's construction), the mean over the
window's solves, from the benchmark's own spans."""


def read(ctx):
    vals = [s.get("upload", 0.0) + s.get("build", 0.0)
            for s in ctx["spans"] if "fit" in s]
    return sum(vals) / len(vals) if vals else None
