"""convert_s: the port's host conversion, ``to_coo`` and
``SparseOperator.from_coo`` with the configuration's PlanSpec, ended by a
device synchronise (host clock). Layer: host conversion; moves setup_s."""


def read(run):
    return run.convert_s if run.stretch is not None else None
