"""The runtime server's busy time a task over the window, in us: the
change of the engine pool's ``server_busy`` over the change of its
finished tasks (``ServingEngine.observe()``); the paper's quantity."""


def read(obs: dict):
    n = obs.get("tasks_finished")
    if not n:
        return None
    return 1e6 * obs["server_busy_s"] / n
