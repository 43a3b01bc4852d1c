"""The open-loop HTTP client of the ``http_clips`` driver, a process of its
own (the standard library only: no torch, no NumPy).

    python3 http_client.py <plan.json> <result.json>

The plan gives the server's address, the route, the bodies' file and each
request's due time (``time.monotonic``'s clock, which every process of the
machine shares), clip and whether its body is kept. The client prints
``ready`` once it has read the bodies, waits for the start time on its
standard input, sends each request when it is due (a connection of its
own, ``Connection: close``) whether or not earlier ones have answered, and
stops ``grace_s`` after the last due time. The result file gives, per
request, its status (0: no answer) and the seconds from its due time to
the response's last byte; kept bodies go to files beside the result.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time


async def _one(plan: dict, req: dict, body: bytes, t0: float, out: list,
               keep_dir: str) -> None:
    due = t0 + req["due"]
    delay = due - time.monotonic()
    if delay > 0:
        await asyncio.sleep(delay)
    status, data = 0, b""
    try:
        reader, writer = await asyncio.open_connection(plan["host"],
                                                       plan["port"])
        head = (f"POST {plan['route']} HTTP/1.1\r\nHost: {plan['host']}\r\n"
                f"Content-Type: audio/wav\r\nContent-Length: {len(body)}\r\n"
                f"Connection: close\r\n\r\n").encode()
        writer.write(head + body)
        await writer.drain()
        line = await reader.readline()
        status = int(line.split()[1])
        length = None
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b""):
                break
            k, _, v = h.decode().partition(":")
            if k.strip().lower() == "content-length":
                length = int(v)
        data = (await reader.readexactly(length) if length is not None
                else await reader.read())
        writer.close()
    except (OSError, ValueError, IndexError, asyncio.IncompleteReadError):
        status = 0
    done = time.monotonic()
    if req["keep"] and status == 200:
        with open(f"{keep_dir}/body_{req['id']}.json", "wb") as f:
            f.write(data)
    out.append({"id": req["id"], "status": status, "latency_s": done - due})


async def _run(plan: dict, bodies: list, t0: float, keep_dir: str) -> list:
    out: list = []
    tasks = [asyncio.create_task(_one(plan, r, bodies[r["clip"]], t0, out,
                                      keep_dir))
             for r in plan["requests"]]
    last = t0 + max((r["due"] for r in plan["requests"]), default=0.0)
    done, pending = await asyncio.wait(
        tasks, timeout=max(0.0, last + plan["grace_s"] - time.monotonic()))
    for t in pending:
        t.cancel()
    await asyncio.gather(*pending, return_exceptions=True)
    for t in done:
        t.result()
    return out


def main(argv: list) -> int:
    plan_path, result_path = argv[1], argv[2]
    with open(plan_path) as f:
        plan = json.load(f)
    with open(plan["bodies"], "rb") as f:
        blob = f.read()
    bodies = [blob[a:b] for a, b in plan["offsets"]]
    print("ready", flush=True)
    t0 = float(sys.stdin.readline())
    out = asyncio.run(_run(plan, bodies, t0, plan["keep_dir"]))
    with open(result_path, "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
