"""Mean requests per micro-batch: the runner calls ``serve.make_runner``'s runner
made during the window, from the harness's spans around it."""


def read(run):
    calls = run.recorder.runner_calls
    return sum(c["requests"] for c in calls) / len(calls) if calls else None
