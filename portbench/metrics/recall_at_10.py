"""recall_at_10: the mean recall@10 of the sampled window answers against
the reference's exact top-10, worked out by the benchmark after the window."""


def read(run):
    return run.judged.get("recall_at_10")
