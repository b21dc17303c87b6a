"""Self-contained web UI served at /ui (mirrors the reference's SPA mount,
tools/server/views.py:54-72 — here a single dependency-free HTML page that
drives the same /v1 API). A copy of `fish_speech_tpu/serve/webui.py`.

Covers the reference Gradio UI surface (tools/webui/__init__.py:59-146):
text, chunk length, max-new-tokens, top-p, repetition penalty (accepted for
API compatibility — v2 sampling replaced it with RAS, see ops/sampling.py),
temperature, seed, saved references, inline reference-audio upload with
reference text, saving uploads as named references — plus the reference
React SPA's extras (awesome_webui/src/App.tsx): request history with
per-item replayable audio and parameter recall, a light/dark theme toggle
(persisted), and a per-request output-format picker (wav/mp3/opus)."""

WEBUI_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>fish-speech-tpu</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
  :root { color-scheme: dark;
    --bg: #101418; --fg: #e6e6e6; --panel: #181e24; --border: #2a323a;
    --muted: #9ab; --accent: #2563eb; --accent2: #6cf; }
  html[data-theme="light"] { color-scheme: light;
    --bg: #f7f8fa; --fg: #1a2027; --panel: #ffffff; --border: #d4dae1;
    --muted: #5a6b7b; --accent: #2563eb; --accent2: #0b72c4; }
  body { font-family: system-ui, sans-serif; max-width: 760px; margin: 2rem auto;
         padding: 0 1rem; background: var(--bg); color: var(--fg); }
  h1 { font-size: 1.3rem; display:flex; align-items:center; gap:.6rem; }
  h1 span { color: var(--accent2); }
  #theme { margin-left:auto; background:var(--panel); color:var(--fg);
           border:1px solid var(--border); border-radius:6px; padding:.3rem .6rem;
           cursor:pointer; font-size:.8rem; }
  textarea { width: 100%; min-height: 7rem; background: var(--panel); color: var(--fg);
             border: 1px solid var(--border); border-radius: 8px; padding: .7rem; }
  .row { display: flex; gap: 1rem; flex-wrap: wrap; margin: .8rem 0; }
  .row label { display: flex; flex-direction: column; font-size: .8rem;
               color: var(--muted); gap: .2rem; }
  input, select { background: var(--panel); color: var(--fg);
                  border: 1px solid var(--border);
                  border-radius: 6px; padding: .35rem .5rem; width: 7rem; }
  button { background: var(--accent); color: white; border: 0; padding: .6rem 1.4rem;
           border-radius: 8px; font-size: 1rem; cursor: pointer; }
  button:disabled { opacity: .5; }
  #status { margin-left: 1rem; color: var(--muted); }
  audio { width: 100%; margin-top: 1rem; }
  #history { margin-top: 1.2rem; border-top: 1px solid var(--border); padding-top: .6rem; }
  #history h2 { font-size: .95rem; color: var(--muted); margin: .2rem 0 .6rem; }
  .hitem { background: var(--panel); border: 1px solid var(--border); border-radius: 8px;
           padding: .5rem .7rem; margin-bottom: .5rem; font-size: .85rem; }
  .hitem .htext { white-space: nowrap; overflow: hidden; text-overflow: ellipsis; }
  .hitem .hmeta { color: var(--muted); font-size: .75rem; margin: .2rem 0; }
  .hitem audio { margin-top: .3rem; height: 2rem; }
  .hitem .hbtns { display:flex; gap:.5rem; margin-top:.3rem; }
  .hitem button { font-size: .75rem; padding: .25rem .7rem; border-radius: 6px;
                  background: var(--border); color: var(--fg); }
</style>
</head>
<body>
<h1>fish-speech-<span>tpu</span>
  <button id="theme" title="toggle theme">theme</button></h1>
<textarea id="text" placeholder="Text to speak…"><|speaker:0|>Hello from the TPU.</textarea>
<div class="row">
  <label>chunk length <input id="chunk" type="number" value="200" min="100" max="1000"></label>
  <label>max new tokens <input id="maxnew" type="number" value="1024"></label>
  <label>top-p <input id="topp" type="number" value="0.8" step="0.05" min="0.1" max="1.0"></label>
  <label>temperature <input id="temp" type="number" value="0.8" step="0.05" min="0.1" max="1.0"></label>
  <label>repetition penalty <input id="reppen" type="number" value="1.1" step="0.05" min="0.9" max="2.0"></label>
  <label>seed <input id="seed" type="number" value="42"></label>
  <label>format <select id="format">
    <option value="wav">wav</option><option value="mp3">mp3</option>
    <option value="opus">opus</option></select></label>
  <label>reference <select id="ref"><option value="">none</option></select></label>
</div>
<details>
  <summary style="color:var(--muted);cursor:pointer">voice cloning (reference audio)</summary>
  <div class="row">
    <label>reference audio <input id="refaudio" type="file" accept="audio/*" style="width:14rem"></label>
    <label style="flex:1;min-width:14rem">reference text
      <input id="reftext" type="text" style="width:100%" placeholder="transcript of the reference audio"></label>
  </div>
  <div class="row">
    <label>save as id <input id="refid" type="text" placeholder="my-voice"></label>
    <button id="saveref" style="align-self:flex-end;background:#374151">Save reference</button>
    <span id="refstatus" style="align-self:flex-end;color:var(--muted)"></span>
  </div>
</details>
<button id="go">Synthesize</button><span id="status"></span>
<audio id="player" controls></audio>
<div id="history"><h2>history</h2><div id="hlist"></div></div>
<script>
// theme toggle, persisted (matches the reference SPA's theming)
const root = document.documentElement;
root.dataset.theme = localStorage.getItem('fst-theme') || 'dark';
document.getElementById('theme').onclick = () => {
  root.dataset.theme = root.dataset.theme === 'dark' ? 'light' : 'dark';
  localStorage.setItem('fst-theme', root.dataset.theme);
};

async function fileToB64(f) {
  const buf = await f.arrayBuffer();
  let s = '';
  const bytes = new Uint8Array(buf);
  for (let i = 0; i < bytes.length; i += 0x8000)
    s += String.fromCharCode.apply(null, bytes.subarray(i, i + 0x8000));
  return btoa(s);
}
document.getElementById('saveref').onclick = async () => {
  const st = document.getElementById('refstatus');
  const f = document.getElementById('refaudio').files[0];
  const id = document.getElementById('refid').value.trim();
  const text = document.getElementById('reftext').value.trim();
  if (!f || !id || !text) { st.textContent = 'need audio + id + text'; return; }
  st.textContent = 'saving…';
  try {
    const r = await fetch('/v1/references/add', { method: 'POST',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({id, text, audio: await fileToB64(f)})});
    if (!r.ok) throw new Error(await r.text());
    st.textContent = 'saved';
    const sel = document.getElementById('ref');
    const o = document.createElement('option');
    o.value = id; o.textContent = id; sel.appendChild(o); sel.value = id;
  } catch (e) { st.textContent = 'error: ' + e.message.slice(0, 120); }
};
</script>
<script>
async function loadRefs() {
  try {
    const r = await fetch('/v1/references/list');
    const data = await r.json();
    const sel = document.getElementById('ref');
    for (const id of data.reference_ids || []) {
      const o = document.createElement('option');
      o.value = id; o.textContent = id; sel.appendChild(o);
    }
  } catch (e) {}
}
loadRefs();

const PARAM_IDS = ['text','chunk','maxnew','topp','temp','reppen','seed','format','ref'];
function snapshotParams() {
  const s = {};
  for (const id of PARAM_IDS) s[id] = document.getElementById(id).value;
  return s;
}
function recallParams(s) {
  for (const id of PARAM_IDS)
    if (s[id] !== undefined) document.getElementById(id).value = s[id];
  window.scrollTo({top: 0, behavior: 'smooth'});
}
// request history with replayable audio + parameter recall (matches the
// reference SPA's history list); object URLs live until the item is
// evicted or removed
function esc(v) {
  return String(v).replace(/[&<>"']/g, ch => ({
    '&': '&amp;', '<': '&lt;', '>': '&gt;', '"': '&quot;', "'": '&#39;'
  }[ch]));
}
function addHistory(params, blob, seconds, mime) {
  const list = document.getElementById('hlist');
  const item = document.createElement('div');
  item.className = 'hitem';
  const url = URL.createObjectURL(blob);
  item.dataset.url = url;
  const when = new Date().toLocaleTimeString();
  // every interpolated value is escaped: reference ids and params are
  // user/attacker-controlled strings landing in innerHTML
  item.innerHTML =
    `<div class="htext">${esc(params.text)}</div>` +
    `<div class="hmeta">${esc(when)} · ${esc(params.format)} · ` +
    `temp ${esc(params.temp)} · top-p ${esc(params.topp)} · ` +
    `seed ${esc(params.seed)}` +
    (params.ref ? ` · ref ${esc(params.ref)}` : '') +
    ` · ${seconds.toFixed(2)}s</div>` +
    `<audio controls src="${url}"></audio>` +
    `<div class="hbtns"><button class="recall">recall params</button>` +
    `<a download="tts.${esc(params.format)}" href="${url}">` +
    `<button>download</button></a>` +
    `<button class="hdel">remove</button></div>`;
  item.querySelector('.recall').onclick = () => recallParams(params);
  item.querySelector('.hdel').onclick = () => {
    URL.revokeObjectURL(url); item.remove();
  };
  list.prepend(item);
  while (list.children.length > 20) {
    const last = list.lastChild;
    if (last.dataset && last.dataset.url)
      URL.revokeObjectURL(last.dataset.url);  // free the evicted blob
    last.remove();
  }
}

document.getElementById('go').onclick = async () => {
  const btn = document.getElementById('go'), st = document.getElementById('status');
  btn.disabled = true; st.textContent = 'generating…';
  const t0 = performance.now();
  const snap = snapshotParams();
  const body = {
    text: snap.text,
    chunk_length: +snap.chunk,
    max_new_tokens: +snap.maxnew,
    top_p: +snap.topp,
    temperature: +snap.temp,
    repetition_penalty: +snap.reppen,
    seed: +snap.seed,
    format: snap.format,
  };
  const ref = snap.ref;
  const refFile = document.getElementById('refaudio').files[0];
  const refText = document.getElementById('reftext').value.trim();
  if (ref) body.reference_id = ref;
  else if (refFile && refText)
    body.references = [{audio: await fileToB64(refFile), text: refText}];
  try {
    const r = await fetch('/v1/tts', { method: 'POST',
      headers: {'Content-Type': 'application/json'}, body: JSON.stringify(body)});
    if (!r.ok) throw new Error(await r.text());
    const blob = await r.blob();
    const secs = (performance.now() - t0) / 1000;
    const p = document.getElementById('player');
    p.src = URL.createObjectURL(blob);
    p.play();
    st.textContent = `done in ${secs.toFixed(2)}s`;
    addHistory(snap, blob, secs, r.headers.get('Content-Type'));
  } catch (e) {
    st.textContent = 'error: ' + e.message.slice(0, 200);
  } finally { btn.disabled = false; }
};
</script>
</body>
</html>
"""
