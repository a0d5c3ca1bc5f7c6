"""setup.prepare_s: host seconds of ``build_example`` and ``prepare_data``,
closed by a synchronise (layer: set-up; moves ``setup_s``)."""


def read(rec):
    return rec["setup"].get("prepare_s")
