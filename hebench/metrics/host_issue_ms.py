"""host_issue_ms: host ms from a request's first call into the program to
its last call's return, before the synchronize; mean over the window."""


def read(r):
    return sum(r.issue_s) / len(r.issue_s) * 1e3 if r.issue_s else None
