"""Loop drivers, one module per ``loop`` kind a mix file names: ``offline`` (a
closed loop of ``AudioCodec.encode`` then ``decode``) and ``http_open_loop``
(the real server under open-loop arrivals).  Each has ``run(run: cell.Run)``,
which fills the run's end-to-end metrics, set-up time, counts, correctness
numbers and trace summary, and ``controls(run, config, sides=None)``, which
gives ``{side: numbers}`` for what ``run`` checked, a ``control`` side among
them (``calibrate.py`` prints them; ``sides``: only those named)."""


def control_sides(config: dict, sides=None) -> dict:
    """{side: {stage: format}} of the codec's controls: ``control`` (the
    configuration's ``control``) and ``control.<name>`` (each of its
    ``stage_controls``); ``sides``: only those named."""
    variants = {"control": config["control"],
                **{f"control.{k}": v for k, v in config.get("stage_controls", {}).items()}}
    return {side: formats for side, formats in variants.items() if sides is None or side in sides}
