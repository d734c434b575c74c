"""Daisen-lite: post-simulation trace visualization (paper §3.6).

Generates a single self-contained HTML file from a DBTracer's task table:
an Overview Panel (tasks-in-flight per location over time) plus a
per-location task timeline with parent-child drill-down on hover — the same
data model as Daisen (overview / component timelines / task hierarchy),
rendered offline with no external dependencies.  A copy of
``repro.core.daisen``.
"""
from __future__ import annotations

import html
import json


def _embed_json(obj) -> str:
    """JSON for embedding inside a ``<script>`` block.

    A task whose ``category``/``action``/``location`` contains
    ``</script>`` (or any markup) would otherwise terminate the script
    element mid-JSON and break — or script-inject — the page.  Escaping
    ``<``, ``>`` and ``&`` to ``\\uXXXX`` keeps the payload valid JSON
    *and* inert HTML (the canonical safe-embedding trick).
    """
    return (json.dumps(obj)
            .replace("&", "\\u0026")
            .replace("<", "\\u003c")
            .replace(">", "\\u003e"))

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Daisen-lite trace</title>
<style>
 body{font-family:monospace;margin:12px;background:#fafafa}
 .lane{position:relative;height:22px;border-bottom:1px solid #eee}
 .lane .name{position:absolute;left:0;width:220px;overflow:hidden;
   font-size:11px;line-height:22px;color:#444}
 .lane .track{position:absolute;left:230px;right:0;top:2px;bottom:2px}
 .task{position:absolute;top:0;height:100%;border-radius:2px;opacity:.85;
   min-width:1px}
 .task:hover{outline:2px solid #000;z-index:5}
 #info{position:fixed;bottom:0;left:0;right:0;background:#222;color:#eee;
   padding:6px;font-size:12px;white-space:pre}
 h3{margin:6px 0}
</style></head><body>
<h3>Daisen-lite — __TITLE__</h3>
<div id="lanes"></div><div id="info">hover a task…</div>
<script>
const TASKS = __TASKS__;
const colors = {};
let ci = 0;
const palette = ['#4c78a8','#f58518','#54a24b','#e45756','#72b7b2',
                 '#b279a2','#ff9da6','#9d755d','#bab0ac','#eeca3b'];
function color(c){ if(!(c in colors)) colors[c]=palette[ci++%palette.length];
  return colors[c]; }
const t0 = Math.min(...TASKS.map(t=>t.start));
const t1 = Math.max(...TASKS.map(t=>t.end));
const span = Math.max(t1-t0, 1e-9);
const byLoc = {};
TASKS.forEach(t=>{(byLoc[t.location] ||= []).push(t);});
const byId = Object.fromEntries(TASKS.map(t=>[t.id,t]));
const lanes = document.getElementById('lanes');
Object.keys(byLoc).sort().forEach(loc=>{
  const lane = document.createElement('div'); lane.className='lane';
  lane.innerHTML = `<div class="name">${loc}</div><div class="track"></div>`;
  const track = lane.querySelector('.track');
  byLoc[loc].forEach(t=>{
    const d = document.createElement('div'); d.className='task';
    d.style.left = (100*(t.start-t0)/span)+'%';
    d.style.width = Math.max(100*(t.end-t.start)/span, .05)+'%';
    d.style.background = color(t.category);
    d.onmouseenter = ()=>{
      let chain=[], cur=t;
      while(cur){chain.unshift(`@${cur.location} ${cur.category}/${cur.action}`
        + ` [${cur.start.toFixed(3)},${cur.end.toFixed(3)}]`);
        cur = byId[cur.parent_id];}
      document.getElementById('info').textContent =
        chain.join('\\n') + '\\ntags: ' + JSON.stringify(t.tags);
    };
    track.appendChild(d);
  });
  lanes.appendChild(lane);
});
</script></body></html>
"""


def export_html(tasks, out_path: str, title: str = "simulation trace"):
    """Write a standalone HTML timeline for a list of completed Tasks."""
    rows = [dict(id=t.id, parent_id=t.parent_id, category=t.category,
                 action=t.action, location=t.location, start=t.start,
                 end=t.end if t.end is not None else t.start, tags=t.tags)
            for t in tasks]
    # positional substitution: sequential .replace() would let a task
    # string containing the literal placeholder text corrupt the page
    head, rest = _TEMPLATE.split("__TITLE__")
    mid, tail = rest.split("__TASKS__")
    doc = head + html.escape(title) + mid + _embed_json(rows) + tail
    with open(out_path, "w") as fh:
        fh.write(doc)
    return out_path


def export_db(db, out_path: str, title: str = "simulation trace"):
    return export_html(db.fetch_tasks(), out_path, title)
