"""Stage 2's share of the traced generate call's device seconds, from the
program's stage clock (``CascadePipeline.stage_seconds()``: timing events
that the fused graph records at the end of each stage and of the pixel
decode): ``stage_2`` over the sum of the parts.  Nothing where the
program gives no stage seconds."""


def read(record, ctx):
    parts = (record.get("trace") or {}).get("stages")
    if not parts or "stage_2" not in parts:
        return None
    return parts["stage_2"] / sum(parts.values())
