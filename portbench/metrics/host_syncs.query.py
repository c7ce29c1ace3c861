"""Host syncs a traced request: device-to-host copies launched inside any
program span (render_view, lift, relevancy; the reply's own copies lie
outside them), over the traced `render_view` spans."""

from harness.spans import syncs_per

read = syncs_per("render_view")
