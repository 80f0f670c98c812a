"""rows_per_s (host clock): the table rows covered by every query that got
its rows inside the window, over the window's seconds. Moves: itself."""


def read(run):
    done = run.completed()
    return run.table_rows * len(done) / run.window_s if done else None
