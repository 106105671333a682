"""One module per ``kind`` of traffic mix, each with ``run(ctx) ->
Outcome``: set-up, the window and the check."""
